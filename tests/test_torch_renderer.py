"""The port's mesh renderer on the CPU: held to the JAX renderer's golden
render (``tests/golden/flame_render_256.npy``) as ``tests/test_renderer.py``
holds JAX's, and to JAX's ``render_meshes`` on two meshes; its grid
helpers equal the JAX package's."""

from pathlib import Path

import numpy as np
import torch

from sr3d_torch.eval import renderer as tr
from sr3d_torch.models.flame import flame_forward, synthetic_flame
from sr3d_tpu.eval import renderer as jr

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "flame_render_256.npy"


def _u8(img) -> np.ndarray:
    return (np.asarray(img).clip(0, 1) * 255).astype(np.uint8)


def test_golden_flame_render():
    """The synthetic FLAME mean head at 256², the golden test's tolerance:
    mean |Δ| < 1 level, fewer than 0.5% of values more than 8 apart."""
    fl = synthetic_flame(n_shape=16, n_exp=8, seed=0)
    verts, _, _ = flame_forward(fl, torch.zeros((1, 16)))
    u8 = _u8(tr.render_mesh(verts[0], fl.faces, image_size=256))
    golden = np.load(GOLDEN)
    assert u8.shape == golden.shape
    d = np.abs(u8.astype(int) - golden.astype(int))
    assert d.mean() < 1.0 and (d > 8).mean() < 0.005


def test_render_meshes_match_jax():
    """Two meshes (a sphere head, and the same rotated under another
    light) through ``render_meshes`` with its auto-sized grid."""
    from sr3d_torch.models.flame import sphere_flame

    fl = sphere_flame(n_shape=8, n_exp=4)
    code = torch.from_numpy(np.random.RandomState(0).randn(2, 8)
                            .astype(np.float32))
    verts, _, _ = flame_forward(fl, code)
    verts = verts.numpy()
    c, s = np.cos(0.4), np.sin(0.4)
    verts[1] = verts[1] @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                   np.float32).T
    faces = fl.faces.numpy()
    for kw in ({}, {"light_dir": (0.3, -0.2, 1.0)}):
        got = tr.render_meshes(torch.from_numpy(verts), fl.faces,
                               image_size=96, **kw).numpy()
        ref = np.asarray(jr.render_meshes(verts, faces, image_size=96, **kw))
        assert got.shape == ref.shape == (2, 96, 96, 3)
        d = np.abs(_u8(got).astype(int) - _u8(ref).astype(int))
        assert d.mean() < 1.0 and (d > 8).mean() < 0.005
        assert (got < 1).mean() > 0.05            # something was drawn
    assert tr.required_tile_grid(verts, faces, 96) == \
        jr.required_tile_grid(verts, faces, 96)


def test_visualize_grid_matches_jax(tmp_path):
    imgs = np.random.RandomState(1).rand(5, 8, 6, 3).astype(np.float32)
    got = tr.visualize_grid(imgs, path=str(tmp_path / "t.png"), ncol=2)
    ref = jr.visualize_grid(imgs, path=str(tmp_path / "j.png"), ncol=2)
    np.testing.assert_array_equal(got, ref)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
