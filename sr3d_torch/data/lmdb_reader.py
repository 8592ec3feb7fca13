"""Read-only pure-Python LMDB parser (plus a minimal writer).

The port's copy of ``sr3d_tpu/data/lmdb_reader.py`` (pure Python, no
``lmdb`` package): the reference's ``datatype: lmdb`` datasets are plain
key → JPEG-bytes LMDB environments, and this module parses the LMDB 0.9
on-disk format (``data.mdb``, format version 1) directly: mmap the file,
pick the newest valid meta page, and walk the main-DB B-tree.  It covers
what the reference writes — plain puts, no DUPSORT/DUPFIXED
sub-databases, no named DBs:

* meta page selection by transaction id (pages 0 and 1);
* branch/leaf node search with the standard node layout;
* F_BIGDATA overflow-page values (large JPEGs span pages).

``write_lmdb`` is the matching minimal writer, enough to build
reference-layout fixtures and round-trip test the reader.  Layout constants
follow the public LMDB format (mdb.c).
"""

from __future__ import annotations

import mmap
import os
import struct
from bisect import bisect_right
from pathlib import Path

MAGIC = 0xBEEFC0DE
FMT_VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2, P_SUBP = 0x20, 0x40
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
PAGEHDRSZ = 16          # pgno u64, pad u16, flags u16, lower u16, upper u16
NODEHDRSZ = 8           # lo u16, hi u16, flags u16, ksize u16
METASZ = 136            # MDB_meta on 64-bit
P_INVALID = 0xFFFF_FFFF_FFFF_FFFF


class LmdbFormatError(RuntimeError):
    """The file is not a readable LMDB environment (or uses features this
    parser does not cover — named/DUPSORT sub-databases)."""


def _parse_db(buf, off):
    """MDB_db: pad u32, flags u16, depth u16, branch/leaf/overflow/entries/
    root u64 each — 48 bytes."""
    pad, flags, depth = struct.unpack_from("<IHH", buf, off)
    branch, leaf, overflow, entries, root = struct.unpack_from(
        "<5Q", buf, off + 8)
    return {"pad": pad, "flags": flags, "depth": depth, "entries": entries,
            "root": root}


class LmdbReader:
    """Read-only view of an LMDB environment's main database.

    ``path`` may be the environment directory (containing ``data.mdb``) or
    a ``.mdb`` file directly.  API: ``get(key: bytes) -> bytes | None``,
    ``len()``, ``keys()``/``items()`` iteration in key order."""

    def __init__(self, path: str | os.PathLike):
        p = Path(path)
        if p.is_dir():
            p = p / "data.mdb"
        if not p.is_file():
            raise LmdbFormatError(f"{path}: no data.mdb found")
        self.path = p
        self._f = open(p, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except ValueError as e:
            raise LmdbFormatError(f"{p}: cannot mmap ({e})") from e
        meta0 = self._parse_meta(0)
        metas = [meta0] if meta0 is not None else []
        if meta0 is not None:
            meta1 = self._parse_meta(meta0["psize"])
            if meta1 is not None:
                metas.append(meta1)
        else:
            # meta page 0 torn (e.g. the env was copied mid-commit or a
            # writer crashed) — LMDB's double-meta design makes this
            # recoverable: probe meta page 1 at each legal page size and
            # accept the one whose recorded psize matches its offset
            ps = 512
            while ps <= 65536:
                m = self._parse_meta(ps)
                if m is not None and m["psize"] == ps:
                    metas.append(m)
                    break
                ps <<= 1
        if not metas:
            raise LmdbFormatError(
                f"{p}: no valid LMDB meta page (pages 0 and 1 both bad)")
        meta = max(metas, key=lambda m: m["txnid"])
        self.psize = meta["psize"]
        self.main = meta["main"]
        if self.main["flags"]:
            # MDB_INTEGERKEY (0x08) keys sort in native-integer order, not
            # the memcmp order this parser's B-tree descent assumes —
            # accepting it would return silently-wrong lookups on
            # multi-page DBs, so reject it like DUPSORT/DUPFIXED.
            raise LmdbFormatError(
                f"{p}: main DB flags 0x{self.main['flags']:x} "
                "(DUPSORT/DUPFIXED/INTEGERKEY not supported by this parser)")

    def _parse_meta(self, off):
        buf = self._mm
        if off + PAGEHDRSZ + METASZ > len(buf):
            return None
        base = off + PAGEHDRSZ
        magic, version = struct.unpack_from("<II", buf, base)
        if magic != MAGIC or version != FMT_VERSION:
            return None
        free = _parse_db(buf, base + 24)
        main = _parse_db(buf, base + 24 + 48)
        (txnid,) = struct.unpack_from("<Q", buf, base + 24 + 96 + 8)
        psize = free["pad"]  # mm_psize aliases mm_dbs[FREE_DBI].md_pad
        if psize < 512 or psize & (psize - 1):
            return None
        return {"psize": psize, "txnid": txnid, "main": main, "free": free}

    # -- page/node primitives -------------------------------------------
    def _page(self, pgno):
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._mm):
            raise LmdbFormatError(f"{self.path}: page {pgno} out of range")
        flags, lower, upper = struct.unpack_from("<HHH", self._mm, off + 10)
        return off, flags, lower, upper

    def _nodes(self, off, lower):
        """(key, node_offset) per node, in stored (sorted) order."""
        n = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{n}H", self._mm, off + PAGEHDRSZ)
        out = []
        for p in ptrs:
            no = off + p
            ksize = struct.unpack_from("<H", self._mm, no + 6)[0]
            out.append((bytes(self._mm[no + 8:no + 8 + ksize]), no))
        return out

    def _leaf_value(self, no):
        lo, hi, flags, ksize = struct.unpack_from("<4H", self._mm, no)
        dsize = lo | (hi << 16)
        if flags & (F_SUBDATA | F_DUPDATA):
            raise LmdbFormatError(
                f"{self.path}: DUPSORT node encountered (unsupported)")
        dstart = no + NODEHDRSZ + ksize
        if flags & F_BIGDATA:
            (opgno,) = struct.unpack_from("<Q", self._mm, dstart)
            ooff = opgno * self.psize
            return bytes(self._mm[ooff + PAGEHDRSZ:
                                  ooff + PAGEHDRSZ + dsize])
        return bytes(self._mm[dstart:dstart + dsize])

    @staticmethod
    def _branch_pgno(mm, no):
        lo, hi, flags = struct.unpack_from("<3H", mm, no)
        return lo | (hi << 16) | (flags << 32)

    # -- public API ------------------------------------------------------
    def __len__(self) -> int:
        return int(self.main["entries"])

    def get(self, key: bytes, default=None):
        if self.main["root"] == P_INVALID:
            return default
        pgno = self.main["root"]
        for _ in range(64):  # depth bound — real trees are ~4 deep
            off, flags, lower, upper = self._page(pgno)
            if flags & P_LEAF:
                for k, no in self._nodes(off, lower):
                    if k == key:
                        return self._leaf_value(no)
                return default
            if not flags & P_BRANCH:
                raise LmdbFormatError(
                    f"{self.path}: page {pgno} flags 0x{flags:x} "
                    "is neither branch nor leaf")
            nodes = self._nodes(off, lower)
            # node 0's key is implicit -inf; descend to the rightmost
            # child whose separator key is <= search key
            keys = [k for k, _ in nodes[1:]]
            i = bisect_right(keys, key)
            pgno = self._branch_pgno(self._mm, nodes[i][1])
        raise LmdbFormatError(f"{self.path}: B-tree deeper than 64 levels")

    def items(self):
        if self.main["root"] == P_INVALID:
            return
        stack = [self.main["root"]]
        while stack:
            pgno = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            if flags & P_LEAF:
                for k, no in self._nodes(off, lower):
                    yield k, self._leaf_value(no)
            elif flags & P_BRANCH:
                children = [self._branch_pgno(self._mm, no)
                            for _, no in self._nodes(off, lower)]
                stack.extend(reversed(children))  # left-to-right order
            else:
                raise LmdbFormatError(
                    f"{self.path}: page {pgno} flags 0x{flags:x} in tree")

    def keys(self):
        for k, _ in self.items():
            yield k

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# minimal writer — reference-layout fixtures + reader round-trip tests
# ---------------------------------------------------------------------------

def _even(n):
    return n + (n & 1)


def write_lmdb(path: str | os.PathLike, kv: dict[bytes, bytes],
               psize: int = 4096) -> Path:
    """Write ``kv`` as a fresh single-snapshot LMDB environment at
    ``path`` (a directory; creates ``data.mdb``).  Keys are sorted; values
    larger than ~1/4 page go to overflow pages (F_BIGDATA) exactly as the
    C library would.  One writer pass, txnid 1 in meta page 1."""
    root_dir = Path(path)
    root_dir.mkdir(parents=True, exist_ok=True)
    items = sorted(kv.items())
    for k, _ in items:
        if not 0 < len(k) <= 511:
            raise ValueError(f"key length {len(k)} outside LMDB limits")

    blobs: list[bytes] = []   # page-aligned blobs, appended in pgno order
    next_pgno = 2             # pages 0/1 are the meta pages
    counts = {"leaf": 0, "branch": 0, "overflow": 0}

    def add_blob(raw: bytes, npages: int) -> int:
        """Append a blob covering ``npages`` pages; returns its first pgno."""
        nonlocal next_pgno
        assert len(raw) == npages * psize
        pgno = next_pgno
        blobs.append(raw)
        next_pgno += npages
        return pgno

    def page_hdr(pgno, flags, lower, upper):
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    bigdata_cutoff = psize // 4

    def leaf_node(key, val):
        if len(val) > bigdata_cutoff:
            npages = -(-(PAGEHDRSZ + len(val)) // psize)
            opgno = next_pgno
            raw = page_hdr(opgno, P_OVERFLOW, npages & 0xFFFF,
                           npages >> 16) + val
            raw += b"\0" * (npages * psize - len(raw))
            add_blob(raw, npages)
            counts["overflow"] += npages
            data, flags = struct.pack("<Q", opgno), F_BIGDATA
        else:
            data, flags = val, 0
        hdr = struct.pack("<4H", len(val) & 0xFFFF, len(val) >> 16,
                          flags, len(key))
        return hdr + key + data

    def emit_node_page(flags, nodes):
        """nodes: raw node byte strings, already key-sorted."""
        ptrs = []
        upper = psize
        for nb in reversed(nodes):
            upper -= _even(len(nb))
            ptrs.insert(0, upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        if upper < lower:
            raise ValueError("node page overflow — keys too large for psize")
        body = bytearray(psize)
        body[0:PAGEHDRSZ] = page_hdr(next_pgno, flags, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
        o = upper
        for nb in nodes:
            body[o:o + len(nb)] = nb
            o += _even(len(nb))
        return add_blob(bytes(body), 1)

    # ---- pack leaves (overflow blobs for a leaf are emitted just before
    # the leaf page itself; pgno order stays monotone) -------------------
    groups, cur, cur_sz = [], [], 0
    for k, v in items:
        need = _even(NODEHDRSZ + len(k)
                     + (8 if len(v) > bigdata_cutoff else len(v))) + 2
        if cur and PAGEHDRSZ + cur_sz + need > psize:
            groups.append(cur)
            cur, cur_sz = [], 0
        cur.append((k, v))
        cur_sz += need
    if cur:
        groups.append(cur)

    depth = 0
    if not groups:
        root = P_INVALID
    else:
        level = []
        for group in groups:
            nodes = [leaf_node(k, v) for k, v in group]
            level.append((group[0][0], emit_node_page(P_LEAF, nodes)))
            counts["leaf"] += 1
        depth = 1
        while len(level) > 1:
            depth += 1
            nxt, i = [], 0
            while i < len(level):
                # greedy fan-out by ACTUAL node size (node 0's key is the
                # implicit -inf, so it is always the smallest) — a fixed
                # per-key estimate overflowed emit_node_page for long keys
                nodes, size, first_key = [], 0, level[i][0]
                while i < len(level):
                    fk, child = level[i]
                    key = b"" if not nodes else fk
                    nb = struct.pack(
                        "<4H", child & 0xFFFF, (child >> 16) & 0xFFFF,
                        (child >> 32) & 0xFFFF, len(key)) + key
                    need = _even(len(nb)) + 2
                    if nodes and PAGEHDRSZ + size + need > psize:
                        break
                    nodes.append(nb)
                    size += need
                    i += 1
                if len(nodes) == 1 and i < len(level):
                    raise ValueError(
                        "branch fan-out < 2 — keys too large for psize")
                nxt.append((first_key, emit_node_page(P_BRANCH, nodes)))
                counts["branch"] += 1
            level = nxt
        root = level[0][1]

    last_pg = next_pgno - 1

    def meta_page(pgno, txnid, genesis):
        """Like the C library, meta page 0 keeps the genesis (empty)
        snapshot and meta page 1 the committed one — txnid picks."""
        db_free = struct.pack("<IHH5Q", psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        if genesis:
            db_main = struct.pack("<IHH5Q", 0, 0, 0, 0, 0, 0, 0, P_INVALID)
        else:
            db_main = struct.pack("<IHH5Q", 0, 0, depth, counts["branch"],
                                  counts["leaf"], counts["overflow"],
                                  len(items), root)
        meta = struct.pack("<II", MAGIC, FMT_VERSION)
        meta += struct.pack("<QQ", 0, max(psize * (last_pg + 1), 1 << 20))
        meta += db_free + db_main
        meta += struct.pack("<QQ", 1 if genesis else last_pg, txnid)
        raw = page_hdr(pgno, P_META, 0, 0) + meta
        return raw + b"\0" * (psize - len(raw))

    out = root_dir / "data.mdb"
    with open(out, "wb") as f:
        f.write(meta_page(0, 0, genesis=True))
        f.write(meta_page(1, 1, genesis=False))
        for b in blobs:
            f.write(b)
    return out
