"""The port's w8a8 int8 path held against the JAX package on the CPU:
``int8_conv``'s quantization and its outputs, ``Int8Conv``'s parameters,
the int8 UNet's gates, ``make_val_step(int8=)`` and the int8 hand-off
(``train_handoff_int8``), on the same numpy inputs, bridged weights and
replayed noise."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.kernels.int8_conv import (
    dynamic_scale,
    int8_conv_reference,
    quantize,
    quantize_weight,
)
from sr3d_torch.models.sr3_unet import SR3UNet as TorchUNet
from sr3d_torch.ops.quant import Int8Conv as TorchInt8Conv
from sr3d_torch.ops.quant import gn_static_scale, int8_conv
from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import flax_to_state_dict, load_jax_params
from sr3d_tpu.config.defaults import get_cfg_defaults, update_cfg
from sr3d_tpu.models.sr3_unet import SR3UNet
from sr3d_tpu.ops.quant import Int8Conv
from sr3d_tpu.ops.quant import int8_conv as jax_int8_conv
from sr3d_tpu.train import joint as jj

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "tiny_8_16_model2.yml")
UNET = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
            attn_res=(8,), res_blocks=1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def oihw(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def ulps(got, ref, dtype):
    """The largest |got − ref| in ulps of ``dtype`` at ``ref``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mant = 23 if dtype == "float32" else 7
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - mant)
    return float(np.max(np.abs(got - ref) / ulp))


# Under jit XLA fuses the quantize into its producer and the dequant into
# an FMA, which rounds otherwise than the formulas as written: the dequant
# by up to ~3 ulp of the product, and a fused GroupNorm can move an
# activation across a quantization step (seen in the UNet below: 0.026 at
# the output, half the elements past 1e-4).  The conv- and UNet-level
# references therefore run op by op, where JAX evaluates each formula as
# written; the UNet is also held to its jitted forward within one such
# step.


def _conv_case(seed, cin=24, cout=16, hw=9):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, hw, hw + 2, cin) * 1.5).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, k, b


def test_quantization_matches_jax_formulas():
    """Activations (dynamic and static step) and weights quantize bit for
    bit as numpy evaluates the JAX package's formulas: a true fp32
    division, round half to even, clip ±127; the steps too."""
    x, k, _ = _conv_case(0)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 126.5]   # ties in units of the step
    xf = torch.from_numpy(x)
    a_np = np.maximum(np.abs(x).max(), np.float32(1e-8)) / np.float32(127)
    a = dynamic_scale(xf)
    assert a.dtype == torch.float32 and float(a) == a_np
    for scale in (a_np, np.float32(1.0), np.float32(0.0123)):
        want = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        got = quantize(xf, torch.tensor(scale)).numpy()
        np.testing.assert_array_equal(got, want)
    w_scale_np = np.maximum(np.abs(k).max(axis=(0, 1, 2)),
                            np.float32(1e-8)) / np.float32(127)
    wq_np = np.clip(np.round(k / w_scale_np), -127, 127).astype(np.int8)
    wq, w_scale = quantize_weight(oihw(k))
    np.testing.assert_array_equal(w_scale.numpy(), w_scale_np)
    np.testing.assert_array_equal(wq.numpy(), wq_np.transpose(3, 2, 0, 1))
    # the static step of a ConvBlock: max(6·max|γ| + max|β|, 1e-3) / 127
    gamma, beta = np.float32([0.5, -1.25, 0.3]), np.float32([0.1, -0.2, 0])
    want = np.maximum(np.float32(6) * np.abs(gamma).max()
                      + np.abs(beta).max(), np.float32(1e-3)) \
        / np.float32(127)
    assert float(gn_static_scale(torch.from_numpy(gamma),
                                 torch.from_numpy(beta))) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_matches_jax(stride, static, dtype):
    """fp32 out within 2 ulp, bf16 out within 1 ulp of JAX's
    ``int8_conv`` op by op (the int32 sums are exact on both sides)."""
    x, k, b = _conv_case(1 + stride)
    a = np.float32(0.021) if static else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_int8_conv(jnp.asarray(x).astype(jdt), jnp.asarray(k),
                        jnp.asarray(b), strides=(stride, stride),
                        padding=[(1, 1), (1, 1)], a_scale=a)
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = int8_conv(nchw(x).to(tdt), oihw(k), torch.from_numpy(b),
                    stride=stride, padding=1, a_scale=a)
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert ulps(got, ref, dtype) <= (2 if dtype == "float32" else 1)


def test_int8_conv_sums_exactly():
    """The plain version's fp64 convolution gives the exact int32 sums of
    the int8 operands (held against int64 im2col) at a width where fp32
    sums would round (K = 9·512, products up to 127²)."""
    g = torch.Generator().manual_seed(2)
    x = torch.rand(1, 512, 5, 5, generator=g) + 0.5   # same-sign products
    w = torch.rand(8, 512, 3, 3, generator=g) + 0.5
    a = dynamic_scale(x)
    xq, (wq, w_scale) = quantize(x, a), quantize_weight(w)
    cols = torch.nn.functional.unfold(xq.double(), 3, padding=1) \
        .round().long()
    exact = (wq.reshape(8, -1).long() @ cols[0]).reshape(1, 8, 5, 5)
    assert int(exact.abs().max()) > 2 ** 24
    out = int8_conv_reference(x, w, a_scale=a)
    want = exact.double().float() * (a * w_scale)[None, :, None, None]
    assert torch.equal(out, want)


def test_int8conv_loads_through_the_bridge():
    """JAX's ``Int8Conv`` parameters load into the port's ``Int8Conv``
    through the bridge unchanged; ``quant=False`` is ``Conv2d``'s forward,
    ``quant=True`` JAX's int8 result op by op (2 ulp)."""
    x = np.random.RandomState(3).randn(2, 8, 8, 16).astype(np.float32)
    for stride in (1, 2):
        jm = Int8Conv(24, (3, 3), strides=(stride, stride),
                      dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(stride), jnp.asarray(x))
        assert jax.tree.structure(params) == jax.tree.structure(
            nn.Conv(24, (3, 3), padding=1).init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
        tm = TorchInt8Conv(16, 24, 3, stride=stride, padding=1)
        tm.load_state_dict(flax_to_state_dict(params))
        with torch.no_grad():
            fp = tm(nchw(x))
            assert torch.equal(fp, torch.nn.functional.conv2d(
                nchw(x), tm.weight, tm.bias, stride, 1))
            got = tm(nchw(x), quant=True).permute(0, 2, 3, 1).numpy()
        ref = np.asarray(jm.apply(params, jnp.asarray(x)))
        assert ulps(got, ref, "float32") <= 2


@pytest.fixture(scope="module")
def int8_unets():
    """JAX's SR3UNet with quant_min_res 1 and resampling on, image_size 32
    over 16² data (the attention track and the actual resolution apart),
    its perturbed weights bridged into the port's."""
    kw = dict(UNET, image_size=32)
    unet = SR3UNet(dropout=0.0, dtype=jnp.float32, quant_min_res=1,
                   quant_resample=True, **kw)
    params = jax.jit(unet.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 1)))
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.randn(*a.shape)
                          .astype(np.float32) * 0.05, params)
    sd = flax_to_state_dict(params)
    ports = {}
    for qmr, rs in ((0, False), (1, True), (16, True)):
        port = TorchUNet(dtype=torch.float32, quant_min_res=qmr,
                         quant_resample=rs, **kw)
        port.load_state_dict(sd)
        ports[qmr] = port.eval()
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 16, 6).astype(np.float32)
    t = rng.rand(2, 1).astype(np.float32)
    return unet, params, ports, x, t


@pytest.mark.parametrize("quant_min_res", [1, 16])
def test_int8_unet_matches_jax(int8_unets, quant_min_res):
    """The int8 UNet against JAX's ``quant=True`` forward.  quant_min_res
    16 quantizes the 16² level only: a gate on NCHW ``shape[1]`` (the
    channels, 16 and 32) or on the image_size track (32, 16) would
    quantize the 8² level too.  Op by op within 1e-4, the fp UNet's
    tolerance (GN sums in another order could still move an activation
    across a quantization step; none does here); the jitted forward
    within 5% of the output's largest entry, one such step propagated
    (see above)."""
    unet, params, ports, x, t = int8_unets
    ref_unet = unet.clone(quant_min_res=quant_min_res)
    ref = np.asarray(ref_unet.apply(params, x, t, quant=True))
    ref_jit = np.asarray(jax.jit(lambda p, x, t: ref_unet.apply(
        p, x, t, quant=True))(params, x, t))
    fp = np.asarray(jax.jit(unet.apply)(params, x, t))
    with torch.no_grad():
        got = ports[quant_min_res](nchw(x), torch.from_numpy(t),
                                   quant=True).permute(0, 2, 3, 1).numpy()
    assert np.abs(ref - fp).max() > 1e-3     # the int8 path engaged
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - ref_jit).max() <= 0.05 * np.abs(ref_jit).max()
    if quant_min_res == 16:   # and it is not the all-levels result
        with torch.no_grad():
            every = ports[1](nchw(x), torch.from_numpy(t), quant=True)
        assert np.abs(every.permute(0, 2, 3, 1).numpy() - got).max() > 1e-4


def test_unet_quant_false_is_fp_bit_for_bit(int8_unets):
    """``quant=False`` is the fp forward bit for bit whatever the knobs;
    ``quant=True`` with quant_min_res 0 too."""
    _, _, ports, x, t = int8_unets
    with torch.no_grad():
        fp = ports[0](nchw(x), torch.from_numpy(t))
        assert torch.equal(ports[1](nchw(x), torch.from_numpy(t)), fp)
        assert torch.equal(ports[16](nchw(x), torch.from_numpy(t),
                                     quant=False), fp)
        assert torch.equal(ports[0](nchw(x), torch.from_numpy(t),
                                    quant=True), fp)


def _tune(cfg):
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    d = cfg.sr.model.diffusion
    d.sampler, d.ddim_steps, d.sampler_init = "ddim", 4, "marginal"
    cfg.sr.model.unet.quant_min_res = 1
    cfg.sr.model.unet.quant_resample = True
    return cfg


@pytest.fixture(scope="module")
def jax_joint():
    """The tiny joint config with int8 knobs, JAX modules and parameters,
    and the port's modules with them bridged in."""
    cfg = _tune(update_cfg(get_cfg_defaults(), CONFIG))
    jmods = jj.build_joint(cfg)
    k_sr, k_af, k_map = jax.random.split(jax.random.PRNGKey(1), 3)
    af = jax.jit(jmods.arcface.init)(k_af, jnp.zeros((1, 112, 112, 3)))
    params = {
        "sr": jax.jit(jmods.unet.init)(k_sr, jnp.zeros((1, 16, 16, 6)),
                                       jnp.zeros((1, 1))),
        "arcface": af["params"],
        "mapping": jax.jit(jmods.mapping.init)(k_map, jnp.zeros((1, 512))),
    }
    state = jj.JointTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               arcface_stats=af["batch_stats"],
                               opt_state=None, ema=None)
    tcfg = _tune(t_update(t_defaults(), CONFIG))
    tmods = tj.build_joint(tcfg, device="cpu")
    load_jax_params(tmods, jax.tree.map(np.asarray, {
        **params, "arcface_stats": af["batch_stats"]}))
    return jmods, state, tmods


def _replayed_noise(key, shape, steps):
    k_init, k_loop = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(k_loop, int(i)), shape,
                                jnp.float32) for i in range(steps - 1, -1, -1)]
    return [torch.from_numpy(np.asarray(d).transpose(0, 3, 1, 2).copy())
            for d in draws]


@pytest.mark.parametrize("int8", [None, False, True])
def test_val_step_int8_matches_jax(jax_joint, int8):
    """``make_val_step(int8=)``: None follows quant_min_res (here 1: int8),
    False forces fp, True int8; the SR sample against JAX's at the fp
    serving tolerance (1e-4), the MICA outputs through the uint8 hand-off
    as ``tests/test_torch_serve.py`` holds them."""
    jmods, state, tmods = jax_joint
    cond = np.random.RandomState(8).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(12)
    ref = jax.tree.map(np.asarray, jax.jit(jj.make_val_step(int8=int8))(
        jmods, state, {"SR": jnp.asarray(cond)}, key))
    out = tj.make_val_step(int8=int8)(
        tmods, {"SR": torch.from_numpy(cond)},
        noise=_replayed_noise(key, cond.shape, 4))
    np.testing.assert_allclose(out["sr"].numpy(), ref["sr"], atol=1e-4)
    for k in ("identity", "verts", "lmk68"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-4,
                                   err_msg=k)
    fp = tj.make_val_step(int8=False)(
        tmods, {"SR": torch.from_numpy(cond)},
        noise=_replayed_noise(key, cond.shape, 4))["sr"]
    assert torch.equal(out["sr"], fp) == (int8 is False)


def test_handoff_int8_samples_as_the_int8_val_step(jax_joint):
    """model2's hand-off under ``train_handoff_int8`` (DDIM η = 1,
    marginal init, train_ddim_steps) is the int8 val step's sample on the
    same noise, bit for bit."""
    _, _, tmods = jax_joint
    mods = tj.dataclasses.replace(tmods, train_handoff_int8=True,
                                  train_sampler="ddim", train_ddim_steps=4,
                                  sched_train=tmods.sched_val)
    cond = torch.from_numpy(np.random.RandomState(9).uniform(
        -1, 1, (2, 16, 16, 3)).astype(np.float32))
    noise = [torch.randn(2, 3, 16, 16,
                         generator=torch.Generator().manual_seed(i))
             for i in range(5)]
    with torch.no_grad():
        hand = tj._handoff_image(mods, cond, cond, None, noise)
    val = tj.make_val_step(int8=True)(tmods, {"SR": cond}, noise=noise)
    fp = tj.make_val_step(int8=False)(tmods, {"SR": cond}, noise=noise)
    assert torch.equal(hand, val["sr"])
    assert not torch.equal(hand, fp["sr"])


def test_handoff_int8_refusals_match_jax():
    """The JAX package's two refusals: a flow-through (differentiable)
    hand-off, and quant_min_res 0."""
    cfg = _tune(t_update(t_defaults(), CONFIG))
    cfg.sr.model.diffusion.train_handoff_int8 = True
    jcfg = _tune(update_cfg(get_cfg_defaults(), CONFIG))
    jcfg.sr.model.diffusion.train_handoff_int8 = True
    for qmr, differentiable, match in ((1, True, "gradient-severed"),
                                       (0, False, "quant_min_res is 0")):
        cfg.sr.model.unet.quant_min_res = jcfg.sr.model.unet.quant_min_res \
            = qmr
        with pytest.raises(ValueError, match=match) as want:
            jj._handoff_denoise_fn(jj.build_joint(jcfg), None,
                                   differentiable)
        with pytest.raises(ValueError, match=match) as got:
            tj._handoff_quant(tj.build_joint(cfg, device="cpu"),
                              differentiable)
        assert str(got.value) == str(want.value)
