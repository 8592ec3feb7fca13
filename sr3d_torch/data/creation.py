"""Offline dataset creation (MICA-style ArcFace prep), numpy and PIL on
the host.

The port's copy of ``sr3d_tpu/data/creation.py``: each ``Instance``
describes where a raw dataset's images and scans live and its per-source
quirks; ``CreationGenerator`` walks them, detects and aligns each face
(insightface RetinaFace where it is installed), and writes the 224 crop,
the 112×112 ArcFace blob ``.npy`` and the actor-keyed
``image_paths/<NAME>.npy`` index that ``data.joint.JointFaceDataset``
reads.  Without insightface, ``align_face`` takes a center square crop
instead: geometry-degraded, but the whole pipeline runs.  The files are
the JAX package's, byte for byte.

    python -m sr3d_torch.data.creation --raw-root <raw> --out-root <out>
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

logger = logging.getLogger("sr3d_torch")

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp"}


@dataclass
class Instance:
    """Per-source adapter (reference instances/instance.py:25-127).

    Subclass or instantiate with the source's paths; the fields below carry
    each source's quirks — image exclusion substrings, per-actor random
    subsampling (FLORENCE takes 1000, PB4D 100), the RetinaFace detector
    threshold, and the scan-mesh normalisation (centre/scale order + fixed
    rotations) the reference routes through pytorch3d.
    """
    name: str = "generic"
    images_root: str = ""
    flame_params_root: str | None = None
    use_pairs: bool = False             # LYHM-style *_1C/_2C pairing
    min_det_score: float = 0.0          # reference get_min_det_score
    image_exclude: tuple = ()           # path substrings to skip
    max_images_per_actor: int = 0       # 0 = keep all
    mesh_scale: float = 1.0
    mesh_scale_first: bool = False      # scale→centre vs centre→scale
    mesh_rotations: tuple = ()          # ((axis, degrees), ...)
    fix_obj: bool = False               # run update_obj before loading
    fix_mtl: bool = False
    subsample_seed: int = 0             # rng for max_images_per_actor picks
    extra: dict = field(default_factory=dict)

    def iter_images(self):
        root = Path(self.images_root)
        by_actor: dict[str, list[Path]] = {}
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() not in IMG_EXTENSIONS:
                continue
            if any(sub in str(p) for sub in self.image_exclude):
                continue
            by_actor.setdefault(self.actor_of(p), []).append(p)
        rng = np.random.RandomState(self.subsample_seed)
        for actor in sorted(by_actor):
            imgs = by_actor[actor]
            if self.max_images_per_actor and \
                    len(imgs) > self.max_images_per_actor:
                # per-actor random subsample (florence.py:40, pb4d.py:38)
                pick = rng.choice(len(imgs), self.max_images_per_actor,
                                  replace=False)
                imgs = [imgs[i] for i in sorted(pick)]
            yield from imgs

    def actor_of(self, img_path: Path) -> str:
        return img_path.parent.name

    def transform_image(self, img: np.ndarray) -> np.ndarray:
        return img

    def transform_mesh(self, verts_or_path) -> np.ndarray:
        """Source-specific scan normalisation (reference transform_mesh)."""
        if isinstance(verts_or_path, (str, os.PathLike)):
            if self.fix_obj:
                update_obj(verts_or_path, fix_mtl=self.fix_mtl)
            from ..eval.export import read_obj
            verts, _ = read_obj(verts_or_path)
        else:
            verts = np.asarray(verts_or_path)
        return transform_mesh_verts(
            verts, scale=self.mesh_scale, scale_first=self.mesh_scale_first,
            rotations=self.mesh_rotations)

    def flame_of(self, actor: str) -> Path | None:
        if self.flame_params_root is None:
            return None
        cand = Path(self.flame_params_root) / actor / "flame.npz"
        return cand if cand.exists() else None


# --------------------------------------------------------------------------
# mesh transforms (pure numpy — the reference routes these through
# pytorch3d RotateAxisAngle / scale_verts_, instances/instance.py:77-90)
# --------------------------------------------------------------------------

def rotation_matrix(axis: str, degrees: float) -> np.ndarray:
    """Right-handed rotation about a principal axis (pytorch3d
    ``_axis_angle_rotation`` convention)."""
    t = np.deg2rad(degrees)
    c, s = np.cos(t), np.sin(t)
    if axis == "X":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    if axis == "Y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    if axis == "Z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    raise ValueError(axis)


def rotate_axis_angle(points: np.ndarray, axis: str,
                      degrees: float) -> np.ndarray:
    """Rotate [N,3] points by ``degrees`` about ``axis`` (the effect of
    pytorch3d ``RotateAxisAngle(deg, axis).transform_points``)."""
    return points @ rotation_matrix(axis, degrees).T


def mesh_rotation_sweep() -> dict:
    """The multi-view render sweep (reference instance.py:77-90):
    X ±7.5° in 2.5° steps (7 views), Y ±72° in 8° steps (19 views);
    returns {axis: [(axis, degrees), ...]}."""
    rots = {}
    for axis, degree, span in (("X", 2.5, 15), ("Y", 8.0, 144)):
        step = int(span / degree / 2)
        rots[axis] = [(axis, degree * i) for i in range(-step, step + 1)]
    return rots


def transform_mesh_verts(verts: np.ndarray, *, scale: float = 1.0,
                         scale_first: bool = False,
                         rotations: tuple = ()) -> np.ndarray:
    """Per-source scan normalisation: centre at the vertex mean and scale
    (order varies by source!), then apply the source's fixed rotations.

    * LYHM/BU3DFE: centre → ×0.01 (lyhm.py:69-80, bu3dfe.py:63-71)
    * PB4D: ×0.01 → centre (pb4d.py:64-70)
    * FRGC: ×10 → centre (frgc.py:76-83)
    """
    v = np.asarray(verts, np.float64)
    if scale_first:
        v = v * scale
        v = v - v.mean(0)
    else:
        v = v - v.mean(0)
        v = v * scale
    for axis, deg in rotations:
        v = rotate_axis_angle(v, axis, deg)
    return v


def update_obj(path, fix_mtl: bool = False) -> None:
    """Normalise an OBJ's material statements (reference
    instance.py:92-127): drop existing ``usemtl``/``newmtl`` lines, add a
    ``usemtl`` right after ``mtllib``, and optionally rewrite the .mtl's
    ``newmtl`` to the mesh stem."""
    path = str(path)
    mesh = Path(path).stem
    with open(path) as f:
        lines = [ln for ln in f.readlines()
                 if "usemtl" not in ln and "newmtl" not in ln]
    out = []
    for ln in lines:
        if "mtllib" in ln:
            mtl = ln.split(" ")[-1].split(".")[0]
            ln += f"usemtl {mtl}\n"
        out.append(ln)
    with open(path, "w") as f:
        f.write("".join(out))
    if not fix_mtl:
        return
    # suffix-only swap (the reference's str.replace('obj','mtl') corrupts
    # paths whose directories contain 'obj')
    mtl_path = str(Path(path).with_suffix(".mtl"))
    if not os.path.exists(mtl_path):
        return
    with open(mtl_path) as f:
        lines = f.readlines()
    with open(mtl_path, "w") as f:
        f.write("".join(
            f"newmtl {mesh}\n" if "newmtl" in ln else ln for ln in lines))


# --------------------------------------------------------------------------
# the reference's nine per-source adapters
# (datasets/creation/instances/*.py) — same directory conventions, image
# filters, per-actor subsampling, detector thresholds, and mesh transforms
# --------------------------------------------------------------------------

@dataclass
class LYHM(Instance):
    """lyhm.py: per-actor ``{src}/{actor}/*.png`` images, ``*.npz`` FLAME
    params, scan meshes centred → ×0.01 → rot X−45°, Y−45°."""
    name: str = "LYHM"
    use_pairs: bool = True
    mesh_scale: float = 0.01
    mesh_scale_first: bool = False
    mesh_rotations: tuple = (("X", -45.0), ("Y", -45.0))


@dataclass
class LYHM_all(LYHM):
    name: str = "LYHM_all"


@dataclass
class Stirling(Instance):
    """stirling.py: HQ images under Real_images__Subset_2D_FG2018, actor =
    stem prefix upper-cased; det threshold 0.75; meshes centred → ×0.01
    after an OBJ/MTL fix."""
    name: str = "STIRLING"
    min_det_score: float = 0.75
    mesh_scale: float = 0.01
    mesh_scale_first: bool = False
    fix_obj: bool = True
    fix_mtl: bool = True

    def actor_of(self, img_path: Path) -> str:
        return img_path.stem.split("_")[0].upper()


@dataclass
class FRGC(Instance):
    """frgc.py: excludes 'Spring2003range' images; meshes OBJ-fixed,
    ×10 → centred."""
    name: str = "FRGC"
    image_exclude: tuple = ("Spring2003range",)
    mesh_scale: float = 10.0
    mesh_scale_first: bool = True
    fix_obj: bool = True


@dataclass
class Florence(Instance):
    """florence.py: excludes 'PTZ-Outdoor', subsamples 1000 images/actor,
    det threshold 0.85."""
    name: str = "FLORENCE"
    image_exclude: tuple = ("PTZ-Outdoor",)
    max_images_per_actor: int = 1000
    min_det_score: float = 0.85


@dataclass
class FaceWarehouse(Instance):
    """facewarehouse.py: Images/*; first FLAME_fits npz per actor."""
    name: str = "FACEWAREHOUSE"


@dataclass
class BU3DFE(Instance):
    """bu3dfe.py: images from the _clean tree; meshes OBJ-fixed,
    centred → ×0.01."""
    name: str = "BU3DFE"
    mesh_scale: float = 0.01
    mesh_scale_first: bool = False
    fix_obj: bool = True


@dataclass
class PB4D(Instance):
    """pb4d.py: subsamples 100 images/actor; meshes ×0.01 → centred.
    The dataset's on-disk name is **BP4D** (the reference class is a
    transposition typo: pb4d.py:31-32 reads/writes ``/scratch/NFC/BP4D``,
    and the shipped index is ``image_paths/BP4D.npy``) — both names
    resolve to this adapter."""
    name: str = "BP4D"
    max_images_per_actor: int = 100
    mesh_scale: float = 0.01
    mesh_scale_first: bool = True


@dataclass
class D3DFACS(Instance):
    """d3dfacs.py: processed/images per-actor trees."""
    name: str = "D3DFACS"


_INSTANCE_TYPES = {
    "LYHM": LYHM, "LYHM_all": LYHM_all, "STIRLING": Stirling,
    "FRGC": FRGC, "FLORENCE": Florence, "FACEWAREHOUSE": FaceWarehouse,
    "BU3DFE": BU3DFE, "BP4D": PB4D, "D3DFACS": D3DFACS,
}
# the reference class is PB4D (a transposition typo for the BP4D dataset,
# pb4d.py:31-32); accept either spelling, process the source once
_NAME_ALIASES = {"PB4D": "BP4D"}


def standard_instances(raw_root: str) -> list[Instance]:
    """The reference's nine sources with their per-source adapters."""
    out = []
    for n, cls in _INSTANCE_TYPES.items():
        out.append(cls(
            name=n,
            images_root=os.path.join(raw_root, n, "images"),
            flame_params_root=os.path.join(raw_root, n,
                                           "FLAME_parameters")))
    return out


def align_face(img_u8: np.ndarray, size: int = 224) -> np.ndarray | None:
    """RetinaFace detect + center-face pick + norm_crop (reference
    generator.py:68-93, util.py:92-106); center-crop fallback."""
    # Face detection is offline prep on the host (insightface runs its own
    # ONNX models there); where insightface is not installed, or finds no
    # face, the center crop is the JAX package's behaviour too.  This is
    # not a fallback from the GPU: no device is involved either way.
    try:  # pragma: no cover — insightface is optional
        from insightface.app import FaceAnalysis
        from insightface.utils import face_align

        if not hasattr(align_face, "_app"):
            app = FaceAnalysis(name="antelopev2")
            app.prepare(ctx_id=-1, det_size=(224, 224))
            align_face._app = app
        faces = align_face._app.get(img_u8[..., ::-1])
        if faces:
            h, w = img_u8.shape[:2]
            c = np.array([w / 2, h / 2])
            best = min(faces, key=lambda f: np.linalg.norm(
                np.asarray(f.bbox).reshape(2, 2).mean(0) - c))
            return face_align.norm_crop(img_u8, best.kps, size)
    except Exception:
        pass
    from PIL import Image

    h, w = img_u8.shape[:2]
    s = min(h, w)
    crop = img_u8[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
    return np.asarray(Image.fromarray(crop).resize((size, size),
                                                   Image.BILINEAR))


def arcface_blob_of(crop224_u8: np.ndarray, size: int = 112) -> np.ndarray:
    """224 crop → CHW BGR ±1 blob (the on-disk format JointFaceDataset
    reads; reference get_arcface_input, creation/util.py:42-45)."""
    from PIL import Image

    small = np.asarray(Image.fromarray(crop224_u8).resize(
        (size, size), Image.BILINEAR), np.float32)
    blob = (small[..., ::-1] - 127.5) / 127.5
    return blob.transpose(2, 0, 1)


def flatten_index(index_npy: str, dataset_path: str, out_dir: str) -> int:
    """Flatten an actor-keyed ``image_paths/<NAME>.npy`` index into one flat
    directory of ``{actor}_{image}`` files (reference
    datasets/tool/prepare_dataset_temp.py:17-28 — a hard-coded one-off
    there; paths are flags here).  Unlike the reference, same-basename
    entries of one actor in different subdirs are disambiguated with the
    full relative path instead of silently overwriting."""
    import shutil

    data = np.load(index_npy, allow_pickle=True).item()
    dst = Path(out_dir)
    dst.mkdir(parents=True, exist_ok=True)
    entries = [(actor, rel) for actor, (image_list, _) in data.items()
               for rel in image_list]
    names = [f"{a}_{Path(r).name}" for a, r in entries]
    n = 0
    for (actor, rel), name in zip(entries, names):
        if names.count(name) > 1:
            name = f"{actor}_" + "_".join(Path(rel).parts)
        shutil.copy(Path(dataset_path) / rel, dst / name)
        n += 1
    return n


def simple_blob_tree(input_root: str, output_root: str, *,
                     size: int = 224, blob_size: int = 112) -> int:
    """Detector-free arcface prep (reference datasets/creation/main_new.py:
    11-54): every image under ``input_root`` → bilinear ``size`` resize saved
    alongside a CHW BGR ±1 ``blob_size`` blob ``.npy``, mirroring the
    directory structure into ``output_root``.

    Used when the images are already face-centred (e.g. the joint dataset's
    own crops) so no detection/alignment is needed.  Deviation: the
    reference ``np.save``s cv2's 4-D ``(1,3,112,112)`` blob verbatim; we
    write the ``(3,112,112)`` layout every reader in this framework (and the
    reference's ``datasets/base.py``) actually consumes."""
    from PIL import Image

    in_root, out_root = Path(input_root), Path(output_root)
    n = 0
    seen: set = set()
    for p in sorted(in_root.rglob("*")):
        if p.suffix.lower() not in IMG_EXTENSIONS:
            continue
        rel = p.relative_to(in_root)
        dst_dir = out_root / rel.parent
        key = dst_dir / p.stem
        if key in seen:
            # x.jpg + x.png in one dir would write the same {stem}.npy —
            # keep the first, never silently serve the wrong blob
            logger.warning("simple: %s shares a blob stem with an earlier "
                           "image; skipping", p)
            continue
        seen.add(key)
        dst_dir.mkdir(parents=True, exist_ok=True)
        img = Image.open(p).convert("RGB").resize((size, size),
                                                  Image.BILINEAR)
        img.save(dst_dir / p.name)
        np.save(dst_dir / f"{p.stem}.npy",
                arcface_blob_of(np.asarray(img), blob_size))
        n += 1
    return n


class CreationGenerator:
    """Walk Instances → write crops, blobs, and the actor-keyed index
    (reference Generator.run, creation/generator.py:50-98)."""

    def __init__(self, instances: list[Instance], out_root: str):
        self.instances = instances
        self.out_root = Path(out_root)

    def run(self) -> dict:
        from PIL import Image

        counts = {}
        for inst in self.instances:
            paths_dict: dict = {}
            n = 0
            for img_path in inst.iter_images():
                img = np.asarray(Image.open(img_path).convert("RGB"))
                img = inst.transform_image(img)
                crop = align_face(img)
                if crop is None:
                    continue
                actor = inst.actor_of(img_path)
                adir = self.out_root / inst.name / "arcface_input" / actor
                adir.mkdir(parents=True, exist_ok=True)
                stem = img_path.stem
                Image.fromarray(crop).save(adir / f"{stem}.jpg")
                np.save(adir / f"{stem}.npy", arcface_blob_of(crop))

                rel = f"{inst.name}/arcface_input/{actor}/{stem}.jpg"
                flame = inst.flame_of(actor)
                entry = paths_dict.setdefault(
                    actor, ([], str(flame) if flame else ""))
                entry[0].append(rel)
                n += 1
            ip = self.out_root / "image_paths"
            ip.mkdir(parents=True, exist_ok=True)
            idx_path = ip / f"{inst.name}.npy"
            if n == 0 and idx_path.exists():
                # never clobber a previously built index with an empty one
                # (e.g. the raw tree was moved/unmounted)
                logger.warning("creation: %s found no images; keeping the "
                               "existing index %s", inst.name, idx_path)
            else:
                np.save(idx_path, paths_dict)
            counts[inst.name] = n
            logger.info("creation: %s → %d aligned images", inst.name, n)
        return counts


def main(argv=None):
    """CLI entry (reference datasets/creation/main.py:38-46 — which
    hard-codes the instance list and paths; here they're flags).

    Example::

        python -m sr3d_torch.data.creation --raw-root /data/raw \
            --out-root datasets --datasets LYHM STIRLING
    """
    import argparse

    ap = argparse.ArgumentParser(
        description="Offline arcface-input dataset creation "
                    "(detect/align/blob/index)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--raw-root",
                      help="root holding <NAME>/images and "
                           "<NAME>/FLAME_parameters per source")
    mode.add_argument("--simple", metavar="DIR",
                      help="detector-free mode (reference creation/"
                           "main_new.py): resize every image under DIR to "
                           "224 and write it + the 112 arcface blob .npy "
                           "into --out-root/arcface_input, mirroring the "
                           "tree")
    mode.add_argument("--flatten-index", metavar="NPY",
                      help="flatten an image_paths/<NAME>.npy index into "
                           "--out-root as {actor}_{image} files (reference "
                           "tool/prepare_dataset_temp.py)")
    ap.add_argument("--dataset-path", metavar="DIR",
                    help="arcface_input root the --flatten-index entries "
                         "are relative to")
    ap.add_argument("--out-root", required=True,
                    help="output root (writes <NAME>/arcface_input/ and "
                         "image_paths/<NAME>.npy)")
    ap.add_argument("--datasets", nargs="+", default=sorted(_INSTANCE_TYPES),
                    choices=sorted(_INSTANCE_TYPES) + sorted(_NAME_ALIASES),
                    metavar="NAME",
                    help="subset of the nine sources (default: all)")
    ap.add_argument("--seed", type=int, default=42,
                    help="rng seed for per-actor subsampling "
                         "(FLORENCE/PB4D; reference main.py:36 uses 42)")
    args = ap.parse_args(argv)

    if args.simple:
        n = simple_blob_tree(
            args.simple, os.path.join(args.out_root, "arcface_input"))
        print(f"simple: {n} images -> {args.out_root}/arcface_input")
        return {"simple": n}
    if args.flatten_index:
        if not args.dataset_path:
            ap.error("--flatten-index requires --dataset-path")
        n = flatten_index(args.flatten_index, args.dataset_path,
                          args.out_root)
        print(f"flattened {n} images -> {args.out_root}")
        return {"flatten": n}
    wanted = {_NAME_ALIASES.get(n, n) for n in args.datasets}
    instances = []
    for inst in standard_instances(args.raw_root):
        if inst.name not in wanted:
            continue
        if not os.path.isdir(inst.images_root):
            # absent sources are skipped, not indexed as empty
            logger.warning("creation: %s has no images at %s — skipping",
                           inst.name, inst.images_root)
            continue
        inst.subsample_seed = args.seed
        instances.append(inst)
    counts = CreationGenerator(instances, args.out_root).run()
    for name, n in counts.items():
        print(f"{name}: {n} aligned images")
    return counts


if __name__ == "__main__":
    main()
