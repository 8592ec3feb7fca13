"""The joint (SR + MICA) per-actor dataset.

The port's copy of ``sr3d_tpu/data/joint.py`` (host numpy and PIL; the same
items as the JAX package for a root, seed and index): items are actors;
each samples K images of its actor (with replacement where it has fewer)
and returns the 224² crops, the 112² ArcFace blobs, the actor's FLAME
parameters and the HR/SR/LR triplets of the SR branch, the triplets of the
train split flipped with one coin per image.  At eval K is one dataset-wide
number (the fewest images of any actor, capped at ``eval_max_k``), so every
batch has the same shapes.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .lrhr import PerItemRng, load_image_m11, transform_augment


def _filter_pairs(img_rels) -> list:
    """LYHM-style ``*_1C``/``*_2C`` pairing (reference scan_img_arcface,
    datasets/base.py:80-113): keep only ``{idx}_{base}_1C`` images whose
    ``_2C`` partner exists with the ADJACENT zero-padded running index
    (``{idx+1}_{base}_2C`` — base.py:104-106), and only the FIRST such pair
    per base name (the reference's ``checked_basenames`` set, :97-111).
    Names without a numeric running index fall back to shared-base
    pairing."""
    stems = {}
    for rel in img_rels:
        stems[Path(rel).stem] = rel
    by_base: dict[str, dict] = {}
    checked_basenames: set[str] = set()
    out = []
    for stem in sorted(stems):
        if not stem.endswith("_1C"):
            continue
        parts = stem[:-len("_1C")].split("_", 1)
        if len(parts) == 2 and parts[0].isdigit():
            idx, base = parts
            if base in checked_basenames:
                continue
            checked_basenames.add(base)
            partner = f"{str(int(idx) + 1).zfill(len(idx))}_{base}_2C"
            if partner in stems:
                out.extend([stems[stem], stems[partner]])
        else:
            # index-free naming: the pair key is the FULL stem minus the
            # view suffix (a prefix-split key would alias unrelated
            # captures sharing a suffix)
            by_base.setdefault(stem[:-len("_1C")], {})["_1C"] = stems[stem]
    for rel in img_rels:  # index-free fallback path
        stem = Path(rel).stem
        if stem.endswith("_2C"):
            parts = stem[:-len("_2C")].split("_", 1)
            if not (len(parts) == 2 and parts[0].isdigit()):
                by_base.setdefault(stem[:-len("_2C")], {})["_2C"] = rel
    for base in sorted(by_base):
        views = by_base[base]
        if "_1C" in views and "_2C" in views:
            out.extend([views["_1C"], views["_2C"]])
    return out


class JointFaceDataset:
    """Actor-keyed dataset reading the reference's cached-path layout
    (``image_paths/<NAME>.npy`` → {actor: ([imgs], flame.npz)},
    datasets/base.py:115-119)."""

    def __init__(
        self,
        root: str | os.PathLike,
        name: str,
        K: int = 4,
        lr_res: int = 16,
        hr_res: int = 128,
        is_train: bool = True,
        n_shape: int = 300,
        n_exp: int = 100,
        eval_max_k: int = 8,
        seed: int = 0,
        use_pairs: bool = False,
        use_flip: bool = True,
    ):
        self.root = Path(root)
        self.name = name
        self.K = int(K)
        self.lr_res = lr_res
        self.hr_res = hr_res
        self.is_train = is_train
        self.n_shape = n_shape
        self.n_exp = n_exp
        self.eval_max_k = eval_max_k
        self.use_flip = use_flip
        self._rng = PerItemRng(seed)

        paths_file = self.root / "image_paths" / f"{name}.npy"
        face_dict = np.load(paths_file, allow_pickle=True).item()
        if use_pairs:
            face_dict = {a: (_filter_pairs(imgs), flame)
                         for a, (imgs, flame) in face_dict.items()}
            face_dict = {a: v for a, v in face_dict.items() if v[0]}
        self.actors = sorted(face_dict.keys())
        self.face_dict = face_dict
        # eval K is DATASET-WIDE fixed (min over actors, capped) so every
        # item has the same static shapes (reference min_max_K,
        # datasets/base.py:183-194, :219) — per-actor K would break batch
        # collation
        self._eval_k = min(
            self.eval_max_k,
            min((len(v[0]) for v in face_dict.values()), default=0))

    def __len__(self) -> int:
        return len(self.actors)

    def skip_item(self, index: int) -> None:
        """Account for one read of ``index`` without reading it (a resumed
        loader's skipped batches): its K draws and flip coins are used
        up."""
        self._rng.for_item(index)

    def _k_indices(self, n_imgs: int, rng) -> np.ndarray:
        if self.is_train:
            # K random picks with replacement if the actor has < K images
            # (reference samples K random, datasets/base.py:216-220)
            replace = n_imgs < self.K
            return rng.choice(n_imgs, self.K, replace=replace)
        return np.arange(self._eval_k)

    def _sr_triplet(self, img_rel: str) -> dict:
        """HR/LR/SR pngs materialised next to the actor
        (layout written by synthetic.generate_synthetic_joint_root and the
        prep tool)."""
        rel = Path(img_rel)
        actor = rel.parent.name
        stem = rel.stem
        srdir = (self.root / self.name / "SR"
                 / f"{self.lr_res}_{self.hr_res}" / actor)
        return {
            "HR": load_image_m11(srdir / f"{stem}_hr.png"),
            "SR": load_image_m11(srdir / f"{stem}_sr.png"),
            "LR": load_image_m11(srdir / f"{stem}_lr.png"),
        }

    def __getitem__(self, index: int) -> dict:
        actor = self.actors[index]
        img_rels, flame_rel = self.face_dict[actor]
        img_rels = list(img_rels)
        # one deterministic per-access generator covers this item's
        # K-sampling and flip coins (thread-safe under the pool loader)
        item_rng = self._rng.for_item(index)
        idxs = self._k_indices(len(img_rels), item_rng)

        images, blobs, hrs, srs, lrs, names = [], [], [], [], [], []
        for i in idxs:
            rel = img_rels[i]
            img = load_image_m11(self.root / rel)          # 224 crop, [-1,1]
            blob_chw = np.load(
                (self.root / rel).with_suffix(".npy")).astype(np.float32)
            blobs.append(blob_chw.transpose(1, 2, 0))       # CHW → HWC
            images.append((img + 1.0) / 2.0)                # [0,1] like /255
            trip = self._sr_triplet(rel)
            if self.is_train and self.use_flip:
                # grouped hflip of the SR triplet per sampled image, one
                # coin for the whole LR/SR/HR group (reference
                # datasets/base.py:305-306 → datasets/util.py:76-83;
                # the 224 crop and arcface blob are not augmented there)
                trip["LR"], trip["SR"], trip["HR"] = transform_augment(
                    [trip["LR"], trip["SR"], trip["HR"]], split="train",
                    rng=item_rng)
            hrs.append(trip["HR"])
            srs.append(trip["SR"])
            lrs.append(trip["LR"])
            names.append(Path(rel).stem)

        flame = np.load(self.root / flame_rel)
        betas = np.asarray(flame["betas"], np.float32).reshape(-1)
        shape = np.zeros(self.n_shape, np.float32)
        exp = np.zeros(self.n_exp, np.float32)
        shape[:min(self.n_shape, betas.shape[0])] = \
            betas[:min(self.n_shape, betas.shape[0])]
        # FLAME 2020 betas pack 300 shape + 100 expression (reference
        # datasets/base.py:227-228 betas[:300] / betas[300:]); synthetic
        # roots with a smaller n_shape pack n_shape + n_exp instead
        off = 300 if betas.shape[0] > 300 else self.n_shape
        if betas.shape[0] > off:
            e = betas[off:off + self.n_exp]
            exp[:e.shape[0]] = e

        K = len(idxs)
        return {
            "image": np.stack(images),                     # [K,224,224,3]
            "arcface": np.stack(blobs),                    # [K,112,112,3]
            "HR": np.stack(hrs),                           # [K,hr,hr,3]
            "SR": np.stack(srs),
            "LR": np.stack(lrs),
            "flame_shape": np.broadcast_to(shape, (K, self.n_shape)).copy(),
            "flame_exp": np.broadcast_to(exp, (K, self.n_exp)).copy(),
            "imagename": names,
            "dataset": self.name,
            "actor": actor,
            "Index": index,
        }
