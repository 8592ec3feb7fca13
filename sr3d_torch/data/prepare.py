"""Offline LR/HR/SR prep tool (PIL on the host).

The port's copy of ``sr3d_tpu/data/prepare.py``: bicubic-resize each
source image to ``l_res`` (LR) and ``r_res`` (HR), bicubic re-upsample
LR→HR as the "SR" conditioning input, write ``lr_{l}/ hr_{r}/
sr_{l}_{r}/`` PNG dirs, optional ``--order`` running-index prefix
(``{i}_{name}.png``); ``--srpk`` packs the dirs into the stores
``data.srpk.SrpkImageDataset`` reads, ``--migrate-lmdb`` converts a
reference LMDB dataset into them.

Usage: ``python -m sr3d_torch.data.prepare --path <imgs> --out <root> --size 16,128``
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
from pathlib import Path


IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def resize_and_convert(img, size: int, resample):
    from PIL import Image

    if img.size[0] != size:
        img = img.resize((size, size), resample)
    return img


def resize_multiple(img, sizes=(16, 128), resample=None):
    """(lr, hr, sr=bicubic(lr→hr)) triplet
    (reference datasets/tool/prepare_data.py:37-47)."""
    from PIL import Image

    resample = resample or Image.BICUBIC
    lr_img = resize_and_convert(img, sizes[0], resample)
    hr_img = resize_and_convert(img, sizes[1], resample)
    sr_img = resize_and_convert(lr_img, sizes[1], resample)
    return lr_img, hr_img, sr_img


def _process_one(args, sizes, out: Path, order: bool):
    i, file = args
    from PIL import Image

    img = Image.open(file).convert("RGB")
    lr, hr, sr = resize_multiple(img, sizes)
    stem = Path(file).stem
    name = f"{i}_{stem}.png" if order else f"{stem}.png"
    lr.save(out / f"lr_{sizes[0]}" / name)
    hr.save(out / f"hr_{sizes[1]}" / name)
    sr.save(out / f"sr_{sizes[0]}_{sizes[1]}" / name)
    return name


def prepare(img_path: str, out_path: str, sizes=(16, 128), n_worker: int = 0,
            order: bool = False) -> int:
    out = Path(out_path)
    for d in (f"lr_{sizes[0]}", f"hr_{sizes[1]}", f"sr_{sizes[0]}_{sizes[1]}"):
        (out / d).mkdir(parents=True, exist_ok=True)

    files = sorted(
        str(p) for p in Path(img_path).rglob("*")
        if p.suffix.lower() in IMG_EXTENSIONS)
    work = list(enumerate(files))
    fn = functools.partial(_process_one, sizes=sizes, out=out, order=order)
    if n_worker > 1:
        with multiprocessing.Pool(n_worker) as pool:
            list(pool.imap_unordered(fn, work))
    else:
        for w in work:
            fn(w)
    return len(files)


def main(argv=None):
    p = argparse.ArgumentParser(description="LR/HR/SR triplet prep")
    p.add_argument("--migrate-lmdb", metavar="LMDB_DIR", default=None,
                   help="migrate an existing reference LMDB dataset "
                        "(datasets/LRHR_dataset.py key scheme) to SRPK "
                        "stores under --out, then exit")
    p.add_argument("--path", "-p", default=None)
    p.add_argument("--out", "-o", required=True)
    p.add_argument("--size", "-s", default="16,128")
    p.add_argument("--n_worker", "-n", type=int,
                   default=min(8, os.cpu_count() or 1))
    p.add_argument("--order", "-od", action="store_true",
                   help="prefix a running index to output names")
    p.add_argument("--srpk", action="store_true",
                   help="also pack the output dirs into SRPK stores "
                        "(the LMDB-mode equivalent)")
    args = p.parse_args(argv)
    sizes = tuple(int(s) for s in args.size.split(","))
    assert len(sizes) == 2, "--size must be 'l,r'"
    if args.migrate_lmdb:
        from .srpk import migrate_lmdb

        counts = migrate_lmdb(args.migrate_lmdb, args.out, *sizes)
        print(f"migrated lmdb -> srpk: {counts}")
        return
    assert args.path, "--path is required (unless --migrate-lmdb)"
    n = prepare(args.path, args.out, sizes, args.n_worker, args.order)
    print(f"prepared {n} images -> {args.out}")
    if args.srpk:
        from .srpk import pack_lrhr_root

        counts = pack_lrhr_root(args.out, sizes[0], sizes[1])
        print(f"packed srpk: {counts}")


if __name__ == "__main__":
    main()
