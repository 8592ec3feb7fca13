"""The port's offline dataset tools held against the JAX package on the
CPU: ``data/creation.py`` (``align_face``'s center-crop path,
``arcface_blob_of``, the ``Instance`` adapters and mesh transforms,
``simple_blob_tree``, ``flatten_index``, ``CreationGenerator`` and the
CLI on a tiny raw tree) and ``data/prepare.py`` (``prepare`` with
``n_worker=0`` and the CLI with ``--srpk``): the same arrays, and the same
files byte for byte, index ``.npy`` included."""

import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sr3d_torch.data import creation as tcr
from sr3d_torch.data import prepare as tprep
from sr3d_tpu.data import creation as jcr
from sr3d_tpu.data import prepare as jprep

torch.set_num_threads(1)


def assert_same_tree(a: Path, b: Path) -> int:
    """Every file under ``a`` and ``b``: the same relative paths, the same
    bytes.  Returns the file count."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel
    return len(fa)


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """A raw tree of one source (FACEWAREHOUSE, the generic adapter): two
    actors with three images of odd sizes each and a FLAME parameter file
    per actor."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(0)
    src = root / "FACEWAREHOUSE"
    for a, actor in enumerate(("a0", "a1")):
        d = src / "images" / actor
        d.mkdir(parents=True)
        for i in range(3):
            h, w = (150 + 10 * i, 130) if a == 0 else (96, 120 + 7 * i)
            Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
                d / f"{i}.jpg")
        fd = src / "FLAME_parameters" / actor
        fd.mkdir(parents=True)
        np.savez(fd / "flame.npz",
                 betas=rng.randn(24).astype(np.float32) * 0.3)
    return root


@pytest.mark.parametrize("shape", [(90, 200, 3), (231, 117, 3),
                                   (224, 224, 3)])
def test_align_face_and_blob_match_jax(shape):
    img = np.random.RandomState(shape[0]).randint(0, 255, shape, np.uint8)
    crop_t, crop_j = tcr.align_face(img), jcr.align_face(img)
    assert crop_t.shape == (224, 224, 3) and crop_t.dtype == np.uint8
    np.testing.assert_array_equal(crop_t, crop_j)
    blob_t, blob_j = tcr.arcface_blob_of(crop_t), jcr.arcface_blob_of(crop_j)
    assert blob_t.dtype == blob_j.dtype and blob_t.shape == (3, 112, 112)
    np.testing.assert_array_equal(blob_t, blob_j)


def test_instances_and_mesh_transforms_match_jax(tmp_path):
    ti = tcr.standard_instances(str(tmp_path))
    ji = jcr.standard_instances(str(tmp_path))
    assert [type(i).__name__ for i in ti] == [type(i).__name__ for i in ji]
    for a, b in zip(ti, ji, strict=True):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    # per-actor subsampling and exclusion
    rng = np.random.RandomState(1)
    for actor in ("x", "y"):
        (tmp_path / "imgs" / actor).mkdir(parents=True)
        for i in range(6):
            name = f"{i}_skipme.png" if i == 5 else f"{i}.png"
            Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(
                tmp_path / "imgs" / actor / name)
    kw = dict(images_root=str(tmp_path / "imgs"), max_images_per_actor=3,
              image_exclude=("skipme",), subsample_seed=4)
    assert list(tcr.Instance(**kw).iter_images()) == \
        list(jcr.Instance(**kw).iter_images())
    p = Path("/x/Real/abcDEF_01.jpg")
    assert tcr.Stirling().actor_of(p) == jcr.Stirling().actor_of(p)
    verts = rng.randn(30, 3) + 4.0
    for cls in ("LYHM", "PB4D", "FRGC", "BU3DFE", "Stirling"):
        np.testing.assert_array_equal(
            getattr(tcr, cls)().transform_mesh(verts),
            getattr(jcr, cls)().transform_mesh(verts))
    for axis in "XYZ":
        np.testing.assert_array_equal(tcr.rotation_matrix(axis, 33.0),
                                      jcr.rotation_matrix(axis, 33.0))
    assert tcr.mesh_rotation_sweep() == jcr.mesh_rotation_sweep()
    # an OBJ scan through update_obj (+ the .mtl fix) and read_obj
    obj = ("mtllib scan.mtl\nusemtl old\n"
           + "".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
           + "f 1 2 3\nf 2/5 3/6 4/7\n")
    for side, mod in (("t", tcr), ("j", jcr)):
        d = tmp_path / f"obj_{side}"
        d.mkdir()
        (d / "scan.obj").write_text(obj)
        (d / "scan.mtl").write_text("newmtl old\nKd 1 1 1\n")
        out = mod.Stirling().transform_mesh(str(d / "scan.obj"))
        np.save(d / "verts.npy", out)
    assert assert_same_tree(tmp_path / "obj_t", tmp_path / "obj_j") == 3


def test_creation_cli_matches_jax(raw_root, tmp_path):
    """``--raw-root`` (with the FLAME parameter files), ``--simple`` and
    ``--flatten-index``: the same counts and files, byte for byte."""
    outs = {}
    for side, mod in (("t", tcr), ("j", jcr)):
        out = tmp_path / side
        counts = mod.main(["--raw-root", str(raw_root), "--out-root",
                           str(out), "--datasets", "FACEWAREHOUSE", "LYHM"])
        outs[side] = counts
    assert outs["t"] == outs["j"] == {"FACEWAREHOUSE": 6}
    assert assert_same_tree(tmp_path / "t", tmp_path / "j") == 13
    idx = np.load(tmp_path / "t" / "image_paths" / "FACEWAREHOUSE.npy",
                  allow_pickle=True).item()
    imgs, flame = idx["a1"]
    assert len(imgs) == 3 and Path(flame).is_file()
    blob = np.load((tmp_path / "t" / imgs[0]).with_suffix(".npy"))
    assert blob.shape == (3, 112, 112) and np.abs(blob).max() <= 1.0

    for side, mod in (("t", tcr), ("j", jcr)):
        assert mod.main(["--simple", str(raw_root / "FACEWAREHOUSE" /
                                         "images"),
                         "--out-root", str(tmp_path / f"simple_{side}")]) \
            == {"simple": 6}
        assert mod.main(["--flatten-index",
                         str(tmp_path / "t" / "image_paths" /
                             "FACEWAREHOUSE.npy"),
                         "--dataset-path", str(tmp_path / "t"),
                         "--out-root", str(tmp_path / f"flat_{side}")]) \
            == {"flatten": 6}
    assert assert_same_tree(tmp_path / "simple_t", tmp_path / "simple_j") \
        == 12
    assert assert_same_tree(tmp_path / "flat_t", tmp_path / "flat_j") == 6


def test_creation_output_feeds_the_joint_dataset(raw_root, tmp_path):
    """The port's ``JointFaceDataset`` reads an item from what the port's
    creation wrote (plus the SR triplets it reads beside the crops)."""
    from sr3d_torch.data.joint import JointFaceDataset

    counts = tcr.CreationGenerator(
        [tcr.FaceWarehouse(images_root=str(raw_root / "FACEWAREHOUSE" /
                                           "images"),
                           flame_params_root=str(raw_root / "FACEWAREHOUSE"
                                                 / "FLAME_parameters"))],
        tmp_path).run()
    assert counts == {"FACEWAREHOUSE": 6}
    idx = np.load(tmp_path / "image_paths" / "FACEWAREHOUSE.npy",
                  allow_pickle=True).item()
    for actor, (imgs, _) in idx.items():
        d = tmp_path / "FACEWAREHOUSE" / "SR" / "8_16" / actor
        d.mkdir(parents=True)
        for rel in imgs:
            crop = Image.open(tmp_path / rel)
            stem = Path(rel).stem
            for tag, size in (("hr", 16), ("lr", 8), ("sr", 16)):
                crop.resize((size, size), Image.BICUBIC).save(
                    d / f"{stem}_{tag}.png")
    ds = JointFaceDataset(tmp_path, "FACEWAREHOUSE", K=2, lr_res=8,
                          hr_res=16, n_shape=16, n_exp=8)
    item = ds[1]
    assert item["arcface"].shape == (2, 112, 112, 3)
    assert item["HR"].shape == (2, 16, 16, 3)
    assert item["flame_shape"].shape == (2, 16)
    assert np.abs(item["flame_shape"]).max() > 0


@pytest.mark.parametrize("order", [False, True])
def test_prepare_matches_jax(raw_root, tmp_path, order):
    src = raw_root / "FACEWAREHOUSE" / "images"
    n_t = tprep.prepare(str(src), str(tmp_path / "t"), (8, 32), 0, order)
    n_j = jprep.prepare(str(src), str(tmp_path / "j"), (8, 32), 0, order)
    assert n_t == n_j == 6
    # without --order the actors' same-named images overwrite each other,
    # in both packages
    assert assert_same_tree(tmp_path / "t", tmp_path / "j") == \
        (18 if order else 9)


def test_prepare_cli_srpk_matches_jax(raw_root, tmp_path):
    from sr3d_torch.data.srpk import SrpkImageDataset

    src = raw_root / "FACEWAREHOUSE" / "images"
    for side, mod in (("t", tprep), ("j", jprep)):
        mod.main(["--path", str(src), "--out", str(tmp_path / side),
                  "--size", "8,16", "--n_worker", "0", "--srpk"])
    assert assert_same_tree(tmp_path / "t", tmp_path / "j") == 12
    ds = SrpkImageDataset(tmp_path / "t", 8, 16, need_LR=True)
    item = ds[0]
    assert len(ds) == 3 and item["HR"].shape == (16, 16, 3)
