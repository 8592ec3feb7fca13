"""The port's small leftovers held against the JAX package on the CPU:
``read_ply`` / ``read_obj`` on files either package wrote, the masking
helpers (triangle weights, soft rings, the masked submesh) bit for bit,
``write_reference_format_assets`` file for file, the FLAME PCA-basis
helpers within 1e-6, ``utils/landmarks.py`` and the package-level
``config.load_config`` / ``parse_args``."""

import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch import config as tconfig
from sr3d_torch.eval import export as te
from sr3d_torch.models import flame as tf
from sr3d_torch.models import masking as tmask
from sr3d_torch.utils import landmarks as tl
from sr3d_tpu import config as jconfig
from sr3d_tpu.eval import export as je
from sr3d_tpu.models import flame as jf
from sr3d_tpu.models import masking as jmask
from sr3d_tpu.utils import landmarks as jl

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_mesh_readers_read_either_packages_files(tmp_path, writer):
    rng = np.random.RandomState(0)
    verts = rng.randn(40, 3).astype(np.float32) * 100
    faces = rng.randint(0, 40, (70, 3)).astype(np.int32)
    mod = te if writer == "torch" else je
    mod.write_ply(tmp_path / "m.ply", verts, faces)
    mod.write_obj(tmp_path / "m.obj", verts, faces)
    for ext in ("ply", "obj"):
        got = getattr(te, f"read_{ext}")(tmp_path / f"m.{ext}")
        want = getattr(je, f"read_{ext}")(tmp_path / f"m.{ext}")
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    v, f = te.read_ply(tmp_path / "m.ply")
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)
    v, f = te.read_obj(tmp_path / "m.obj")
    np.testing.assert_allclose(v, verts, atol=1e-5)
    np.testing.assert_array_equal(f, faces)


def test_eval_package_exports_the_readers():
    import sr3d_torch.eval as tev
    import sr3d_tpu.eval as jev

    assert tev.read_ply is te.read_ply and tev.read_obj is te.read_obj
    assert set(jev.__all__) <= set(tev.__all__)


def _mesh(seed=0, n=60):
    f = jf.sphere_flame(n_rings=6, n_segments=8, seed=seed)
    return np.asarray(f.faces), f.n_vertices


def test_masking_leftovers_bit_equal():
    faces, V = _mesh()
    masks = jmask.synthetic_masks(V, seed=3)
    weights = {"whole": 1.0, "face": 3.0, "nose": 5.0, "eyes": 0.5}
    vw = jmask.weights_per_vertex(masks, weights, V)
    for got, want in (
            (tmask.triangle_weights(vw, faces),
             jmask.triangle_weights(vw, faces)),
            (tmask.weights_with_soft_rings(masks, weights, faces, V),
             jmask.weights_with_soft_rings(masks, weights, faces, V)),
            (tmask.weights_with_soft_rings(masks, weights, faces, V,
                                           ("face", "nose"), 2),
             jmask.weights_with_soft_rings(masks, weights, faces, V,
                                           ("face", "nose"), 2)),
            (tmask.binary_triangle_mask(faces, masks["face"]),
             jmask.binary_triangle_mask(faces, masks["face"]))):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    nb_t = tmask.vertex_neighbours(faces, V)
    assert nb_t == jmask.vertex_neighbours(faces, V)
    for (ia, va), (ib, vb) in zip(
            tmask.make_soft(masks["nose"], 4.0, nb_t, 3),
            jmask.make_soft(masks["nose"], 4.0, nb_t, 3), strict=True):
        np.testing.assert_array_equal(ia, ib)
        assert va == vb
    tri = jmask.binary_triangle_mask(faces, masks["face"])
    verts = np.random.RandomState(1).randn(V, 3).astype(np.float32)
    for a, b in zip(tmask.masked_submesh(verts, faces, tri),
                    jmask.masked_submesh(verts, faces, tri), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_write_reference_format_assets_same_files(tmp_path):
    """The same seed writes the same pickles and ``.npy`` in both
    packages, and both ``load_flame``s read them to the same arrays."""
    pt = tf.write_reference_format_assets(str(tmp_path / "t"), 48, seed=2)
    pj = jf.write_reference_format_assets(str(tmp_path / "j"), 48, seed=2)
    assert set(pt) == set(pj) == {"flame_model", "lmk_embedding", "masks"}
    for k in pt:
        assert filecmp.cmp(pt[k], pj[k], shallow=False), k
    mt = tf.load_flame(pt["flame_model"], pt["lmk_embedding"], n_shape=8)
    mj = jf.load_flame(pj["flame_model"], pj["lmk_embedding"], n_shape=8)
    for field in ("faces", "v_template", "shapedirs", "posedirs",
                  "J_regressor", "lbs_weights", "lmk_faces_idx",
                  "lmk_bary_coords", "dynamic_lmk_faces_idx",
                  "dynamic_lmk_bary_coords", "full_lmk_faces_idx",
                  "full_lmk_bary_coords"):
        np.testing.assert_array_equal(
            getattr(mt, field).numpy(), np.asarray(getattr(mj, field)),
            err_msg=field)
    np.testing.assert_array_equal(mt.parents, np.asarray(mj.parents))
    assert (mt.n_shape, mt.n_exp) == (mj.n_shape, mj.n_exp) == (8, 100)
    masks = tmask.load_masks(pt["masks"])
    assert set(masks) == set(jmask.load_masks(pj["masks"]))


@pytest.mark.parametrize("offset", [False, True])
def test_pca_helpers_match_jax(offset):
    mj = jf.synthetic_flame(n_vertices=90, n_shape=12, n_exp=4, seed=5)
    mt = tf.synthetic_flame(n_vertices=90, n_shape=12, n_exp=4, seed=5)
    rng = np.random.RandomState(0)
    x = (np.asarray(mj.v_template)[None]
         + rng.randn(3, 90, 3).astype(np.float32) * 0.02)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(
        tf.project_to_shape_basis(mt, xt, offset).numpy(),
        np.asarray(jf.project_to_shape_basis(mj, xj, offset)), atol=1e-6)
    np.testing.assert_allclose(
        tf.compute_distance_to_basis(mt, xt, offset).numpy(),
        np.asarray(jf.compute_distance_to_basis(mj, xj, offset)), atol=1e-6)
    np.testing.assert_allclose(tf.get_std(mt).numpy(),
                               np.asarray(jf.get_std(mj)), atol=1e-6)
    for a, b in zip(tf.compute_closest_shape(mt, xt),
                    jf.compute_closest_shape(mj, xj), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_landmarks_module_matches_jax():
    rng = np.random.RandomState(0)
    lmk68 = rng.rand(3, 68, 2).astype(np.float32) * 200
    np.testing.assert_array_equal(tl.fan_landmarks_to_kps(lmk68),
                                  jl.fan_landmarks_to_kps(lmk68))
    img = np.zeros((90, 120, 3), np.uint8)
    for a, b in zip(tl.center_fallback(img), jl.center_fallback(img),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tl.LandmarksDetector("dlib")
    for name in ("retinaface", "fan"):
        # the optional detector packages are absent here: a plain
        # ImportError, as in the JAX package
        try:
            import insightface  # noqa: F401
            import face_alignment  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError):
                tl.LandmarksDetector(name)


@pytest.mark.parametrize("argv", [
    ["-c", "configs/tiny_8_16_model2.yml"],
    ["-c", "configs/sr_sr3_VGGF2_16_128_model2.yml", "-p", "val", "-s", "3",
     "-ckt", "ckpt.npz", "-m", "model2", "seed", "7",
     "mica.train.lr", "0.5", "name", "over"],
    [],
])
def test_load_config_and_parse_args_match_jax(argv):
    argv = [str(REPO / a) if a.startswith("configs/") else a for a in argv]
    got = tconfig.parse_args(argv).to_dict()
    want = jconfig.parse_args(argv).to_dict()
    got.pop("sr3d_dir"), want.pop("sr3d_dir")
    assert got == want
    got = tconfig.load_config(argv[1] if argv else None, phase="val",
                              overrides=["sr.train.optimizer.lr", 0.25])
    want = jconfig.load_config(argv[1] if argv else None, phase="val",
                               overrides=["sr.train.optimizer.lr", 0.25])
    got, want = got.to_dict(), want.to_dict()
    got.pop("sr3d_dir"), want.pop("sr3d_dir")
    assert got == want and got["sr"]["train"]["optimizer"]["lr"] == 0.25
