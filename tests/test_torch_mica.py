"""The port's MICA branch held against the JAX package on the CPU: ArcFace
iResNet (full 112² input and widths, depth cut to one block per stage),
the mapping network, and FLAME on the seeded synthetic model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.models import flame as tf
from sr3d_torch.models.arcface import IResNet as TorchIResNet
from sr3d_torch.models.mapping import MappingNetwork as TorchMapping
from sr3d_torch.utils.bridge import flax_to_state_dict
from sr3d_tpu.models import flame as jf
from sr3d_tpu.models.arcface import IResNet
from sr3d_tpu.models.mapping import MappingNetwork

torch.set_num_threads(1)


def _perturbed_stats(stats, seed):
    """BatchNorm running statistics away from their 0/1 init, so the bridge
    and the eval-mode arithmetic are both exercised."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a + rng.randn(*a.shape).astype(np.float32) * 0.1

    return jax.tree_util.tree_map_with_path(f, stats)


def test_arcface_matches_jax():
    """fp32 both sides; 11 conv layers of fp32 sums in different orders,
    then a 25088-wide FC: ~1e-5 on O(1) embeddings."""
    net = IResNet(layers=(1, 1, 1, 1), dtype=jnp.float32)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 112, 112, 3)) \
        .astype(np.float32)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 112, 112, 3)))
    stats = _perturbed_stats(variables["batch_stats"], 1)
    ref = np.asarray(jax.jit(net.apply)(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x)))
    port = TorchIResNet(layers=(1, 1, 1, 1), dtype=torch.float32)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]))
    sd.update(flax_to_state_dict(stats))
    port.load_state_dict(sd)
    with torch.no_grad():   # eval(): BatchNorm on the running statistics
        out = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)
                          .contiguous())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hidden", [3, 6])
def test_mapping_matches_jax(hidden):
    """hidden=3 is the configs' value; hidden=6 takes the skip concat."""
    net = MappingNetwork(z_dim=512, map_hidden_dim=64, map_output_dim=16,
                         hidden=hidden)
    params = net.init(jax.random.PRNGKey(hidden), jnp.zeros((1, 512)))
    z = np.random.RandomState(hidden).randn(3, 512).astype(np.float32)
    ref = np.asarray(net.apply(params, jnp.asarray(z)))
    port = TorchMapping(512, 64, 16, hidden)
    port.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = port(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_synthetic_flame_is_bit_identical():
    a = jf.synthetic_flame(n_vertices=200, n_shape=16, n_exp=8, seed=3)
    b = tf.synthetic_flame(n_vertices=200, n_shape=16, n_exp=8, seed=3)
    for name in ("faces", "v_template", "shapedirs", "posedirs",
                 "J_regressor", "lbs_weights", "lmk_faces_idx",
                 "lmk_bary_coords", "dynamic_lmk_faces_idx",
                 "dynamic_lmk_bary_coords", "full_lmk_faces_idx",
                 "full_lmk_bary_coords", "parents", "neck_kin_chain"):
        got = getattr(b, name)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(getattr(a, name)),
                                      err_msg=name)


@pytest.mark.parametrize("kind", ["synthetic", "sphere"])
def test_flame_forward_and_landmarks_match_jax(kind):
    """Posed decode (neck/jaw/eye poses drive the dynamic contour rows and
    the kinematic chain); fp32 einsums in different orders, ~1e-7."""
    if kind == "synthetic":
        jm = jf.synthetic_flame(n_shape=16, n_exp=8, seed=0)
        tm = tf.synthetic_flame(n_shape=16, n_exp=8, seed=0)
    else:
        jm = jf.sphere_flame(n_shape=16, n_exp=8, seed=1)
        tm = tf.sphere_flame(n_shape=16, n_exp=8, seed=1)
    rng = np.random.RandomState(4)
    shape = rng.randn(3, 16).astype(np.float32)
    expr = rng.randn(3, 8).astype(np.float32) * 0.5
    pose = rng.randn(3, 6).astype(np.float32) * 0.3
    neck = rng.randn(3, 3).astype(np.float32) * 0.6
    eye = rng.randn(3, 6).astype(np.float32) * 0.1
    ref = jax.jit(jf.flame_forward)(jm, *(jnp.asarray(a) for a in
                                          (shape, expr, pose, eye, neck)))
    out = tf.flame_forward(tm, *(torch.from_numpy(a) for a in
                                 (shape, expr, pose, eye, neck)))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
    np.testing.assert_allclose(
        tf.compute_landmarks(tm, out[0]).numpy(),
        np.asarray(jax.jit(jf.compute_landmarks)(jm, ref[0])), atol=1e-5)


def test_load_flame_missing_assets_raises():
    with pytest.raises(FileNotFoundError):
        tf.load_flame("no/such/generic_model.pkl", "no/such/lmk.npy")


def test_load_flame_reads_reference_format(tmp_path):
    """The real on-disk formats (written by the JAX package's fixture
    writer) load to the same arrays in both packages."""
    paths = jf.write_reference_format_assets(str(tmp_path), n_vertices=64)
    a = jf.load_flame(paths["flame_model"], paths["lmk_embedding"],
                      n_shape=300)
    b = tf.load_flame(paths["flame_model"], paths["lmk_embedding"],
                      n_shape=300)
    assert (b.n_shape, b.n_exp) == (a.n_shape, a.n_exp)
    np.testing.assert_array_equal(b.shapedirs.numpy(),
                                  np.asarray(a.shapedirs))
    np.testing.assert_array_equal(b.full_lmk_faces_idx.numpy(),
                                  np.asarray(a.full_lmk_faces_idx))
    np.testing.assert_array_equal(b.parents, np.asarray(a.parents))
