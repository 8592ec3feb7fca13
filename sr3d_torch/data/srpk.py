"""SRPK packed tensor store: the native reader (ctypes) and its plain
version.

The port's counterpart of ``sr3d_tpu/data/srpk.py``: fixed-shape uint8 or
float32 records after a 128-byte header, read by the repository's
``native/srpk.cc`` (mmap, a threaded batch gather).  The port compiles that
source with ``g++`` into the git-ignored ``build/native/`` at its first
use, and loads that build; a failed build raises.  The numpy-memmap reader
of the same format is the plain version, reached only by asking for it
(``native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HEADER = 128
_MAGIC = b"SRPK\x00\x00\x00\x01"
_DTYPES = {0: np.uint8, 1: np.float32}
_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1}


REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "srpk.cc"
BUILD_DIR = REPO / "build" / "native"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_lock = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srpk_open.restype = ctypes.c_void_p
    lib.srpk_open.argtypes = [ctypes.c_char_p]
    lib.srpk_close.argtypes = [ctypes.c_void_p]
    lib.srpk_count.restype = ctypes.c_uint64
    lib.srpk_count.argtypes = [ctypes.c_void_p]
    lib.srpk_record_bytes.restype = ctypes.c_uint64
    lib.srpk_record_bytes.argtypes = [ctypes.c_void_p]
    lib.srpk_ndim.restype = ctypes.c_uint64
    lib.srpk_ndim.argtypes = [ctypes.c_void_p]
    lib.srpk_shape.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint64)]
    lib.srpk_dtype.restype = ctypes.c_uint32
    lib.srpk_dtype.argtypes = [ctypes.c_void_p]
    lib.srpk_read.restype = ctypes.c_int
    lib.srpk_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.c_void_p]
    lib.srpk_read_batch.restype = ctypes.c_int
    lib.srpk_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]
    return lib


def native_library() -> ctypes.CDLL:
    """The library built from ``native/srpk.cc`` (compiled with ``g++`` on
    the first call; the file name carries a hash of the source and flags).
    Raises with the compiler's output where the build fails."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
        target = BUILD_DIR / f"libsrpk-{h.hexdigest()[:12]}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            gxx = shutil.which(os.environ.get("CXX", "g++")) or "g++"
            proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o",
                                   str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        _LIB = _declare(ctypes.CDLL(str(target)))
        return _LIB


def _make_header(count: int, shape: tuple, dtype: np.dtype) -> bytes:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if len(shape) > 8:
        raise ValueError("at most 8 record dims")
    record_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    header = bytearray(_HEADER)
    header[0:8] = _MAGIC
    header[8:16] = np.uint64(count).tobytes()
    header[16:24] = np.uint64(record_bytes).tobytes()
    header[24:32] = np.uint64(len(shape)).tobytes()
    header[32:32 + 8 * len(shape)] = np.asarray(shape, np.uint64).tobytes()
    header[96:100] = np.uint32(_DTYPE_CODES[dtype]).tobytes()
    return bytes(header)


def pack(path: str | os.PathLike, arrays: np.ndarray) -> None:
    """Write [N, ...] uint8/float32 tensors as an SRPK file (pure python —
    packing is offline, reading is the hot path).  N may be 0 (valid empty
    store: record_bytes comes from the shape, not arrays[0])."""
    arrays = np.ascontiguousarray(arrays)
    with open(path, "wb") as f:
        f.write(_make_header(arrays.shape[0], arrays.shape[1:],
                             np.dtype(arrays.dtype)))
        f.write(arrays.tobytes())


def pack_stream(path: str | os.PathLike, records, count: int,
                shape: tuple, dtype) -> None:
    """Streaming pack: write ``count`` records from an iterable one at a
    time (O(1 record) memory — for migrations too large to materialise)."""
    dtype = np.dtype(dtype)
    n = 0
    with open(path, "wb") as f:
        f.write(_make_header(count, tuple(shape), dtype))
        for rec in records:
            rec = np.ascontiguousarray(rec, dtype)
            if rec.shape != tuple(shape):
                raise ValueError(f"record {n}: shape {rec.shape} != {shape}")
            f.write(rec.tobytes())
            n += 1
    if n != count:
        raise ValueError(f"wrote {n} records, header promised {count}")


class SrpkReader:
    """Random-access reader; ``read_batch`` is the per-step gather.  ``native``:
    the ``native/srpk.cc`` reader (built at first use), else the numpy-memmap
    reader of the same format (the plain version)."""

    def __init__(self, path: str | os.PathLike, threads: int = 4,
                 native: bool = True):
        self.path = str(path)
        self.threads = threads
        self._handle = None
        self._lib = native_library() if native else None
        if self._lib is not None:
            self._handle = self._lib.srpk_open(self.path.encode())
            if not self._handle:
                raise OSError(f"srpk_open failed: {path}")
            self.count = int(self._lib.srpk_count(self._handle))
            ndim = int(self._lib.srpk_ndim(self._handle))
            shp = (ctypes.c_uint64 * 8)()
            self._lib.srpk_shape(self._handle, shp)
            self.shape = tuple(int(shp[i]) for i in range(ndim))
            self.dtype = np.dtype(_DTYPES[int(self._lib.srpk_dtype(self._handle))])
            self.record_bytes = int(self._lib.srpk_record_bytes(self._handle))
        else:
            with open(self.path, "rb") as f:
                header = f.read(_HEADER)
            if header[:8] != _MAGIC:
                raise OSError(f"bad SRPK magic in {path}")
            self.count = int(np.frombuffer(header, np.uint64, 1, 8)[0])
            self.record_bytes = int(np.frombuffer(header, np.uint64, 1, 16)[0])
            ndim = int(np.frombuffer(header, np.uint64, 1, 24)[0])
            self.shape = tuple(
                int(x) for x in np.frombuffer(header, np.uint64, ndim, 32))
            self.dtype = np.dtype(
                _DTYPES[int(np.frombuffer(header, np.uint32, 1, 96)[0])])
            self._mm = np.memmap(self.path, dtype=self.dtype, mode="r",
                                 offset=_HEADER,
                                 shape=(self.count,) + self.shape)

    def __len__(self) -> int:
        return self.count

    def read(self, idx: int) -> np.ndarray:
        if self._handle is not None:
            out = np.empty(self.shape, self.dtype)
            rc = self._lib.srpk_read(self._handle, int(idx),
                                out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IndexError(idx)
            return out
        return np.array(self._mm[idx])

    def read_batch(self, indices) -> np.ndarray:
        indices = np.ascontiguousarray(indices, np.uint64)
        n = len(indices)
        out = np.empty((n,) + self.shape, self.dtype)
        if self._handle is not None:
            rc = self._lib.srpk_read_batch(
                self._handle,
                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                n, out.ctypes.data_as(ctypes.c_void_p), self.threads)
            if rc != 0:
                raise IndexError("index out of range in batch")
            return out
        out[:] = self._mm[indices.astype(np.int64)]
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.srpk_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class SrpkImageDataset:
    """LRHR-style dataset over three SRPK stores (hr/sr/[lr]) of uint8
    images — the packed-store twin of LRHRDataset, with the SAME train-split
    semantics: grouped random hflip across the triplet
    (reference datasets/util.py:76-83 via the lmdb datatype) and the
    ``data_len`` cap."""

    def __init__(self, root: str | os.PathLike, l_res: int, r_res: int,
                 need_LR: bool = False, threads: int = 4,
                 split: str = "val", data_len: int = -1,
                 use_flip: bool = True, seed: int = 0,
                 native: bool = True):
        from .lrhr import PerItemRng

        root = Path(root)
        self.hr = SrpkReader(root / f"hr_{r_res}.srpk", threads, native)
        self.sr = SrpkReader(root / f"sr_{l_res}_{r_res}.srpk", threads,
                             native)
        self.lr = (SrpkReader(root / f"lr_{l_res}.srpk", threads, native)
                   if need_LR else None)
        assert len(self.hr) == len(self.sr)
        self.split = split
        self.use_flip = use_flip
        self._rng = PerItemRng(seed)
        self.data_len = (len(self.hr) if data_len <= 0
                         else min(data_len, len(self.hr)))

    def __len__(self) -> int:
        return self.data_len

    def skip_item(self, idx: int) -> None:
        """Account for one read of ``idx`` without reading it (a resumed
        loader's skipped batches): its flip coin is used up."""
        if self.split == "train" and self.use_flip:
            self._rng.for_item(idx)

    def __getitem__(self, idx: int) -> dict:
        from .lrhr import transform_augment

        to_m11 = lambda a: a.astype(np.float32) / 127.5 - 1.0
        item = {"HR": to_m11(self.hr.read(idx)),
                "SR": to_m11(self.sr.read(idx)), "Index": idx,
                "path_sr": f"{self.sr.path}#{idx}"}
        if self.lr is not None:
            item["LR"] = to_m11(self.lr.read(idx))
        if self.split == "train" and self.use_flip:
            keys = [k for k in ("LR", "SR", "HR") if k in item]
            flipped = transform_augment([item[k] for k in keys], "train",
                                        rng=self._rng.for_item(idx))
            item.update(zip(keys, flipped))
        return item

    def read_batch(self, indices) -> dict:
        to_m11 = lambda a: a.astype(np.float32) / 127.5 - 1.0
        out = {"HR": to_m11(self.hr.read_batch(indices)),
               "SR": to_m11(self.sr.read_batch(indices))}
        if self.lr is not None:
            out["LR"] = to_m11(self.lr.read_batch(indices))
        return out


def pack_image_dir(img_dir, out_path, size: int | None = None) -> int:
    """Pack a directory of images into one SRPK of uint8 HWC records
    (offline; the packed twin of a ``lr_*/hr_*/sr_*`` PNG dir)."""
    from PIL import Image

    from .lrhr import get_paths_from_images

    paths = get_paths_from_images(img_dir)
    first = np.asarray(Image.open(paths[0]).convert("RGB"))
    h, w = (size, size) if size else first.shape[:2]
    arrays = np.empty((len(paths), h, w, 3), np.uint8)
    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB")
        if size and img.size != (size, size):
            img = img.resize((size, size), Image.BICUBIC)
        arrays[i] = np.asarray(img)
    pack(out_path, arrays)
    return len(paths)


def pack_lrhr_root(root, l_res: int, r_res: int, out_root=None) -> dict:
    """Pack the three LRHR dirs of a dataset root into SRPK stores readable
    by ``SrpkImageDataset`` (prep-tool companion)."""
    from pathlib import Path

    root = Path(root)
    out_root = Path(out_root) if out_root else root
    out_root.mkdir(parents=True, exist_ok=True)
    counts = {}
    for name in (f"hr_{r_res}", f"sr_{l_res}_{r_res}", f"lr_{l_res}"):
        src = root / name
        if src.is_dir():
            counts[name] = pack_image_dir(src, out_root / f"{name}.srpk")
    return counts


def migrate_lmdb_records(get, length: int, l_res: int, r_res: int,
                         out_root) -> dict:
    """Core of the lmdb→srpk migration, decoupled from the lmdb package:
    ``get(key: bytes) -> bytes | None`` returns encoded image bytes for the
    reference LMDB key scheme (reference datasets/LRHR_dataset.py:52-66 —
    ``hr_{r}_{i:05d}`` / ``sr_{l}_{r}_{i:05d}`` / ``lr_{l}_{i:05d}``).
    Writes ``{hr,sr[,lr]}_*.srpk`` stores readable by SrpkImageDataset."""
    import io

    from PIL import Image

    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)

    def decode(raw):
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))

    streams = {
        f"hr_{r_res}": lambda i: get(f"hr_{r_res}_{i:05d}".encode()),
        f"sr_{l_res}_{r_res}":
            lambda i: get(f"sr_{l_res}_{r_res}_{i:05d}".encode()),
        f"lr_{l_res}": lambda i: get(f"lr_{l_res}_{i:05d}".encode()),
    }
    # SrpkImageDataset pairs records by POSITION, so all streams must keep
    # exactly the same index set: an index is valid only when hr AND sr
    # exist (the reference resamples such indices, LRHR_dataset.py:67-70)
    # and, when the LMDB carries an LR stream at all, lr too.
    #
    # Two-pass streaming migration (O(1 record) resident — a review found
    # the previous version materialised every raw byte string AND every
    # decoded frame for all streams at once): pass 1 records presence
    # only; pass 2 streams each store through pack_stream.
    has_lr = any(streams[f"lr_{l_res}"](i) is not None
                 for i in range(length))
    active = [n for n in streams
              if has_lr or not n.startswith("lr_")]
    valid = [i for i in range(length)
             if all(streams[n](i) is not None for n in active)]
    counts = {}
    for name in active:
        if not valid:
            break
        first = decode(streams[name](valid[0]))
        pack_stream(out_root / f"{name}.srpk",
                    (decode(streams[name](i)) for i in valid),
                    len(valid), first.shape, np.uint8)
        counts[name] = len(valid)
    return counts


def migrate_lmdb(lmdb_dir, out_root, l_res: int, r_res: int) -> dict:
    """Migrate an existing reference LMDB dataset to SRPK stores
    with the ``lmdb`` package where it is installed, else with the
    pure-Python parser (``data.lmdb_reader``)."""
    try:
        import lmdb
    except ImportError:
        from .lmdb_reader import LmdbReader

        with LmdbReader(lmdb_dir) as r:
            raw = r.get(b"length")
            if raw is None:
                raise KeyError(
                    f"{lmdb_dir}: no 'length' record — not a reference "
                    f"SR dataset LMDB (datasets/base.py writes it)")
            return migrate_lmdb_records(r.get, int(raw), l_res, r_res,
                                        out_root)
    env = lmdb.open(str(lmdb_dir), readonly=True, lock=False,
                    readahead=False, meminit=False)
    with env.begin(write=False) as txn:
        raw = txn.get(b"length")
        if raw is None:
            raise KeyError(
                f"{lmdb_dir}: no 'length' record — not a reference "
                f"SR dataset LMDB (datasets/base.py writes it)")
        return migrate_lmdb_records(txn.get, int(raw), l_res, r_res,
                                    out_root)
