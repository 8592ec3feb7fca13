"""Image files of the LR/HR/SR datasets: the scan and the [−1, 1] decode.

The port's copy of the part of ``sr3d_tpu/data/lrhr.py`` that serving
needs (the reference's ``datasets/util.py`` scan and its ``min_max=(−1, 1)``
transform); the dataset classes come with the data slice.  Host numpy and
PIL only.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def get_paths_from_images(path: str | os.PathLike) -> list[str]:
    """Every image under ``path``, recursively, in sorted order.  Raises
    where ``path`` is no directory or holds no image."""
    if not os.path.isdir(path):
        raise NotADirectoryError(f"{path} is not a valid directory")
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if Path(fname).suffix.lower() in IMG_EXTENSIONS:
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise FileNotFoundError(f"{path} has no valid image file")
    return images


def decode_image_m11(raw) -> np.ndarray:
    """Encoded image bytes (a file object) or a path → float32 HWC RGB in
    [−1, 1]: ``x / 127.5 − 1``."""
    from PIL import Image

    img = np.asarray(Image.open(raw).convert("RGB"), dtype=np.float32)
    return img / 127.5 - 1.0


def load_image_m11(path: str | os.PathLike) -> np.ndarray:
    """PNG/JPG file → float32 HWC in [−1, 1] (see ``decode_image_m11``)."""
    return decode_image_m11(path)
