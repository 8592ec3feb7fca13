"""The SR-only LR/HR/SR triplet dataset, and the image scan and decode.

The port's copy of ``sr3d_tpu/data/lrhr.py``: ``LRHRDataset`` reads
``{root}/lr_{l}``, ``{root}/hr_{r}``, ``{root}/sr_{l}_{r}`` image dirs
(``datatype: img``) or a reference LMDB environment (``datatype: lmdb``,
through the pure-Python ``lmdb_reader``) and returns [−1, 1] float32 HWC
arrays keyed ``HR``/``SR``/[``LR``] plus the source path; the train split
flips each triplet together with one coin.  Host numpy and PIL only: the
same items as the JAX package for a root, seed and index.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


class PerItemRng:
    """A deterministic ``RandomState`` per access, safe under the threaded
    ``BatchLoader``: the generator of an access comes from ``(seed, index,
    how often index was accessed before)``, so draws do not depend on how
    threads interleave and still change from epoch to epoch."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._counts: dict[int, int] = {}
        self._lock = threading.Lock()

    def for_item(self, index: int) -> np.random.RandomState:
        with self._lock:
            count = self._counts.get(index, 0)
            self._counts[index] = count + 1
        ss = np.random.SeedSequence([self.seed, int(index), count])
        return np.random.RandomState(ss.generate_state(4))


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
    [−1, 1]: ``x / 127.5 − 1``.  The one normalisation of the img and lmdb
    datatypes."""
    from PIL import Image

    img = np.asarray(Image.open(raw).convert("RGB"), dtype=np.float32)
    return img / 127.5 - 1.0


def load_image_m11(path: str | os.PathLike) -> np.ndarray:
    """PNG/JPG file → float32 HWC in [−1, 1] (see ``decode_image_m11``)."""
    return decode_image_m11(path)


def transform_augment(imgs: list[np.ndarray], split: str = "val",
                      rng: np.random.RandomState | None = None
                      ) -> list[np.ndarray]:
    """The train split's random horizontal flip, one coin for the whole
    group (the LR/HR/SR triplet flips together); other splits unchanged."""
    if split == "train":
        rng = rng or np.random
        if rng.rand() < 0.5:
            imgs = [np.ascontiguousarray(im[:, ::-1]) for im in imgs]
    return imgs


class LRHRDataset:
    """Items ``{"HR", "SR", ["LR"], "Index", "path_sr"}``.

    ``datatype``: ``img`` scans ``{root}/{sr_l_r, hr_r, [lr_l]}``; ``lmdb``
    reads a reference LMDB environment (keys ``hr_{r}_{i:05d}``,
    ``sr_{l}_{r}_{i:05d}``, ``lr_{l}_{i:05d}`` and ``length``), resampling
    an index whose records are missing as the reference does; anything
    else raises ``NotImplementedError`` (the packed ``srpk`` stores are
    ``data.srpk.SrpkImageDataset``)."""

    def __init__(
        self,
        dataroot: str | os.PathLike,
        l_resolution: int = 16,
        r_resolution: int = 128,
        split: str = "train",
        data_len: int = -1,
        need_LR: bool = False,
        use_flip: bool = True,
        seed: int = 0,
        datatype: str = "img",
    ):
        self.l_res = l_resolution
        self.r_res = r_resolution
        self.need_LR = need_LR
        self.split = split
        self.use_flip = use_flip
        self.datatype = datatype
        self._rng = PerItemRng(seed)

        root = Path(dataroot)
        if datatype == "lmdb":
            from .lmdb_reader import LmdbReader

            self._env = LmdbReader(root)
            raw = self._env.get(b"length")
            if raw is None:
                raise KeyError(
                    f"{root}: LMDB has no 'length' key — not a reference "
                    "SR dataset environment")
            self.dataset_len = int(raw)
            self.sr_paths = None
        elif datatype == "img":
            self.sr_paths = get_paths_from_images(
                root / f"sr_{l_resolution}_{r_resolution}")
            self.hr_paths = get_paths_from_images(root / f"hr_{r_resolution}")
            if need_LR:
                self.lr_paths = get_paths_from_images(
                    root / f"lr_{l_resolution}")
            self.dataset_len = len(self.hr_paths)
        else:
            raise NotImplementedError(
                f"data_type [{datatype}] is not recognized "
                "(use 'img', 'lmdb', or datatype: srpk at the config level)")
        self.data_len = (self.dataset_len if data_len <= 0
                         else min(data_len, self.dataset_len))

    def __len__(self) -> int:
        return self.data_len

    def skip_item(self, index: int) -> None:
        """Account for one read of ``index`` without reading it (a resumed
        loader's skipped batches): its flip coin is used up."""
        if self.split == "train" and self.use_flip:
            self._rng.for_item(index)

    def _lmdb_images(self, index: int):
        """hr/sr/[lr] arrays of ``index``; an index with a missing record
        is resampled from the item's own generator."""
        import io as _io

        def fetch(i):
            hr = self._env.get(f"hr_{self.r_res}_{i:05d}".encode())
            sr = self._env.get(
                f"sr_{self.l_res}_{self.r_res}_{i:05d}".encode())
            lr = (self._env.get(f"lr_{self.l_res}_{i:05d}".encode())
                  if self.need_LR else None)
            return hr, sr, lr

        hr_b, sr_b, lr_b = fetch(index)
        rng = None
        for _ in range(4 * self.data_len):
            if hr_b is not None and sr_b is not None:
                break
            rng = rng or self._rng.for_item(index)
            hr_b, sr_b, lr_b = fetch(int(rng.randint(0, self.data_len)))
        if hr_b is None or sr_b is None:
            raise RuntimeError(
                f"{self._env.path}: could not find a valid hr/sr record "
                f"pair after resampling (started at index {index})")

        def dec(raw):
            return decode_image_m11(_io.BytesIO(raw))

        return dec(hr_b), dec(sr_b), (dec(lr_b) if lr_b is not None
                                      else None)

    def __getitem__(self, index: int) -> dict:
        if self.datatype == "lmdb":
            hr, sr, lr = self._lmdb_images(index)
        else:
            hr = load_image_m11(self.hr_paths[index])
            sr = load_image_m11(self.sr_paths[index])
            lr = (load_image_m11(self.lr_paths[index])
                  if self.need_LR else None)
        if self.split == "train" and self.use_flip:
            group = [hr, sr] + ([lr] if lr is not None else [])
            group = transform_augment(group, "train",
                                      self._rng.for_item(index))
            hr, sr = group[0], group[1]
            lr = group[2] if lr is not None else None
        path_sr = (f"lmdb:sr_{self.l_res}_{self.r_res}_{index:05d}"
                   if self.datatype == "lmdb"
                   else str(self.sr_paths[index]))
        item = {"HR": hr, "SR": sr, "Index": index, "path_sr": path_sr}
        if lr is not None:
            item["LR"] = lr
        return item
