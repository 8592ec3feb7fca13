"""The GN+Swish backward on the CPU: its closed form
(``gn_swish_backward_reference``, the plain twin of the backward kernels)
against autograd of ``gn_swish_reference`` and against ``jax.vjp`` of the
JAX package's ``groupnorm_swish_reference``; ``gn_bwd_plan``'s choice at
every GN input of the training paths (meta-device traces); and a torch
emulation of the one-pass kernel's split of the work (which rank and warp
sums which vectors, and in which order the partials are added).  The
kernels themselves are held to the closed form on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.kernels import gn_swish_backward
from sr3d_torch.kernels.groupnorm_swish import (
    GN_BWD_CTA_BYTES,
    GN_BWD_MAX_CG,
    GN_THREADS,
    gn_bwd_plan,
    gn_stats_reference,
    gn_swish_backward_reference,
    gn_swish_reference,
)
from sr3d_tpu.kernels.groupnorm_swish import groupnorm_swish_reference

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32


def _raw_group_var(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The one-pass group variance ``E[x²] − E[x]²`` before the clamp."""
    B, C, H, W = x.shape
    s, q = gn_stats_reference(x)
    n = H * W * (C // groups)
    m = s.view(B, groups, -1).sum(-1) / n
    return q.view(B, groups, -1).sum(-1) / n - m * m


def _case(name: str, dtype: torch.dtype):
    """(x, γ, β, gy, groups) of one named case, from a numpy seed."""
    rng = np.random.RandomState(11)
    shape, G = {"hw1": ((3, 16, 1, 1), 4), "cg1": ((2, 8, 4, 6), 8),
                "gamma_zeros": ((2, 12, 4, 4), 3),
                "clamp": ((1, 8, 32, 32), 2),
                "gy_view": ((2, 8, 5, 7), 4)}[name]
    C = shape[1]
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    gamma = rng.rand(C).astype(np.float32) + 0.5
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    if name == "gamma_zeros":
        gamma[::2] = 0
    if name == "clamp":
        # a near-constant map at a large mean: one value a group is the
        # next bf16 number, and the fp32 moments cancel below 0
        x = np.full(shape, 2208.0, np.float32)
        x[0, 0, 0, 0] = x[0, 4, 3, 5] = 2224.0
    gy_t = torch.from_numpy(gy).to(dtype)
    if name == "gy_view":  # a non-contiguous gy
        gy_t = torch.from_numpy(np.ascontiguousarray(
            gy.transpose(0, 1, 3, 2))).to(dtype).transpose(2, 3)
        assert not gy_t.is_contiguous()
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(gamma),
            torch.from_numpy(beta), gy_t, G)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", ["hw1", "cg1", "gamma_zeros", "clamp",
                                  "gy_view"])
def test_closed_form_matches_autograd(case, dtype):
    """The closed form against autograd of ``gn_swish_reference``.  On the
    inputs' values in fp32, each gradient within 1e-5 of its scale (fp32
    arithmetic in other orders); dx in bf16 is rounded once, so within one
    bf16 ulp (2^-8 relative) more.  Against autograd of the bf16 plain
    version, which rounds the gradients of its two paths to x (through the
    moments and through the normalisation) to bf16 before it adds them,
    within two bf16 ulps of dx's scale."""
    x, gamma, beta, gy, G = _case(case, dtype)
    if case == "clamp":
        assert (_raw_group_var(x, G) < 0).all(), "the clamp is not hit"

    def autograd(x, gy):
        ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        return torch.autograd.grad(gn_swish_reference(*ins, G), ins, gy)

    got = gn_swish_backward_reference(x, gamma, beta, gy, G)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == F32
    ref = autograd(x.float(), gy.float())
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, ref):
        scale = float(b.abs().max()) + 1e-12
        rtol = 2 ** -8 if (name == "dx" and dtype == BF16) else 0.0
        torch.testing.assert_close(a.float(), b, rtol=rtol,
                                   atol=1e-5 * scale, msg=name)
    if dtype == BF16:
        ref = autograd(x, gy)
        scale = float(ref[0].float().abs().max())
        torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=0,
                                   atol=2 ** -6 * scale)
    # the CPU wrapper is the closed form, and honours ``need``
    for t, u in zip(gn_swish_backward(x, gamma, beta, gy, G), got):
        assert torch.equal(t, u)
    assert gn_swish_backward(x, gamma, beta, gy, G,
                             need=(False, True, False))[::2] == (None, None)


_jax_vjp = jax.jit(lambda x, g, b, gy: jax.vjp(
    lambda *a: groupnorm_swish_reference(*a, 4), x, g, b)[1](gy))


def test_closed_form_matches_jax_vjp():
    """The closed form against ``jax.vjp`` of the JAX package's
    ``groupnorm_swish_reference`` (NHWC, transposed at the boundary), fp32:
    each gradient within 1e-4 of its scale."""
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 8, 6, 16) * 2 + 0.5).astype(np.float32)
    gamma = (rng.rand(16) + 0.5).astype(np.float32)
    beta = (rng.randn(16) * 0.1).astype(np.float32)
    gy = rng.randn(2, 8, 6, 16).astype(np.float32)
    ref = _jax_vjp(*map(jnp.asarray, (x, gamma, beta, gy)))
    got = gn_swish_backward_reference(
        *(torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
          if a.ndim == 4 else torch.from_numpy(a)
          for a in (x, gamma, beta, gy)), 4)
    got = (got[0].permute(0, 2, 3, 1), got[1], got[2])
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def _train_gn_inputs(monkeypatch, which: str) -> set:
    """(C, H, W, groups) of every GN+Swish input of one train-mode forward
    of the flagship config's UNet (``which_model_G`` ``which``) at its
    training resolution, traced on the meta device."""
    import sr3d_torch.models.sr3_unet as unet_mod
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.models.networks import define_g

    cfg = update_cfg(get_cfg_defaults(), str(
        ROOT / "configs" / "sr_sr3_VGGF2_16_128_model2.yml"))
    cfg.sr.model.which_model_G = which
    seen = set()

    def record(x, gamma, beta, groups, eps=1e-5):
        seen.add((*x.shape[1:], groups))
        return x

    monkeypatch.setattr(unet_mod, "gn_swish", record)
    monkeypatch.setattr(unet_mod, "spatial_attention",
                        lambda q, k, v, channels=None: q)
    hr = int(cfg.sr.datasets.train.r_resolution)
    with torch.device("meta"), torch.no_grad():
        unet, time_input = define_g(cfg.sr.model, remat=True)
        unet.train()
        t = torch.zeros(1, 1) if time_input == "gamma" else torch.zeros(1)
        unet(torch.zeros(1, int(cfg.sr.model.unet.in_channel), hr, hr), t)
    return seen


def _partition(plan, HW: int, per_vec: int) -> list:
    """The one-pass backward kernel's split of a group's vectors, restated
    from ``gn_bwd_onepass_kernel``: per rank, per warp, the segments
    ``(first vector, end, channel)`` it sums, in the order it sums them."""
    n, S, nw = plan.group_vectors, plan.cluster, plan.threads // 32
    vpc = HW // per_vec
    out = []
    for r in range(S):
        v0 = n * r // S
        cnt = n * (r + 1) // S - v0
        warps = []
        for w in range(nw):
            i, hi, segs = cnt * w // nw, cnt * (w + 1) // nw, []
            while i < hi:
                cl = (v0 + i) // vpc
                end = min(hi, (cl + 1) * vpc - v0)
                segs.append((v0 + i, v0 + end, cl))
                i = end
            warps.append(segs)
        out.append(warps)
    return out


@pytest.mark.parametrize("which", ["sr3", "ddpm"])
@pytest.mark.parametrize("B", [4, 2, 1])
def test_gn_bwd_plan_takes_every_training_input_in_one_pass(monkeypatch, B,
                                                            which):
    """Every GN input of the flagship's train step (its UNet and the DDPM
    family's, at the joint step's B = 4, SR-only's 2 and 1) takes the
    one-pass backward in bf16 and fp32, within the kernel's budget, and its
    split covers each vector of a group once."""
    shapes = _train_gn_inputs(monkeypatch, which)
    assert len(shapes) >= 10
    for C, H, W, G in sorted(shapes):
        for dtype in (BF16, F32):
            per_vec = 8 if dtype == BF16 else 4
            plan = gn_bwd_plan(B, C, G, H * W, dtype)
            assert plan.path == "onepass", (C, H, W, dtype, plan.why)
            assert plan.cluster in (1, 2, 4, 8)
            assert plan.threads % 32 == 0 and plan.threads <= GN_THREADS
            assert C // G <= GN_BWD_MAX_CG
            assert plan.group_vectors * per_vec == C // G * H * W
            assert 32 * -(-plan.group_vectors // plan.cluster) \
                <= GN_BWD_CTA_BYTES
            hits = np.zeros(plan.group_vectors, np.int64)
            for warps in _partition(plan, H * W, per_vec):
                for segs in warps:
                    for lo, hi, cl in segs:
                        hits[lo:hi] += 1
                        assert lo // (H * W // per_vec) == cl
                        assert (hi - 1) // (H * W // per_vec) == cl
            assert (hits == 1).all(), (C, H, W, dtype)


def test_gn_bwd_plan_fills_the_card_and_sends_other_shapes_multipass():
    # the flagship's widest group, bf16: 48 KB of x and gy a rank
    p = gn_bwd_plan(4, 192, 32, 128 * 128, BF16)
    assert (p.path, p.cluster, p.threads) == ("onepass", 8, 256)
    # 8² × 1024 at B = 4: 128 groups of 8 KB stay one CTA each
    assert gn_bwd_plan(4, 1024, 32, 64, BF16).cluster == 1
    # H·W = 1 and 4 (the small configs): no 16-byte vectors in bf16
    for hw in (1, 4, 35):
        p = gn_bwd_plan(2, 64, 32, hw, BF16)
        assert p.path == "multipass" and "not a multiple" in p.why
    # a group of 128 channels
    p = gn_bwd_plan(1, 256, 2, 64, BF16)
    assert p.path == "multipass" and "channels a group" in p.why
    # 16 channels of 128² in fp32: 2 MB of x and gy, more than 8 CTAs hold
    p = gn_bwd_plan(1, 512, 32, 128 * 128, F32)
    assert p.path == "multipass" and "exceed" in p.why


def _emulate_bwd_onepass(x, gamma, beta, gy, G, eps, plan):
    """The one-pass backward kernel's arithmetic in torch (fp32): the
    moments as the forward kernel takes them (rank shares, rank order),
    then per-channel sums of dz and dz·x̂ per warp segment, the warps' slots
    added in warp order, the ranks' in rank order; dx from them."""
    B, C, H, W = x.shape
    per_vec = 8 if x.dtype == BF16 else 4
    cg, n = C // G, C // G * H * W
    xf, gf = x.float().reshape(B, G, -1), gy.float().reshape(B, G, -1)
    parts = _partition(plan, H * W, per_vec)
    dx = torch.empty(B, G, n)
    P = torch.zeros(B, C)
    Q = torch.zeros(B, C)
    for b in range(B):
        for g in range(G):
            v, gv = xf[b, g], gf[b, g]
            s = q = torch.zeros(())
            for r in range(plan.cluster):
                lo = plan.group_vectors * r // plan.cluster * per_vec
                hi = plan.group_vectors * (r + 1) // plan.cluster * per_vec
                s, q = s + v[lo:hi].sum(), q + (v[lo:hi] ** 2).sum()
            mean = s / n
            raw = q / n - mean * mean
            rstd = 1 / torch.sqrt(raw.clamp_min(0) + eps)
            ch = g * cg + torch.arange(n) // (H * W)
            xh = (v - mean) * rstd
            z = xh * gamma[ch] + beta[ch]
            sg = torch.sigmoid(z)
            dz = gv * sg * (1 + z * (1 - sg))
            rank_part = []
            for warps in parts:
                slots = torch.zeros(len(warps), cg, 2)
                for w, segs in enumerate(warps):
                    for lo, hi, cl in segs:
                        e = slice(lo * per_vec, hi * per_vec)
                        slots[w, cl] = torch.stack(
                            (dz[e].sum(), (dz[e] * xh[e]).sum()))
                rank_part.append(slots.sum(0))
            tot = torch.zeros(cg, 2)
            for part in rank_part:      # rank order
                tot = tot + part
            P[b, g * cg:(g + 1) * cg], Q[b, g * cg:(g + 1) * cg] = tot.T
            m1 = (gamma[g * cg:(g + 1) * cg] * tot[:, 0]).sum() / n
            m2 = (gamma[g * cg:(g + 1) * cg] * tot[:, 1]).sum() / n \
                * (raw >= 0)
            dx[b, g] = rstd * (dz * gamma[ch] - m1 - xh * m2)
    return dx.reshape(x.shape).to(x.dtype), Q.sum(0), P.sum(0)


@pytest.mark.parametrize("shape,G,dtype", [
    ((1, 192, 128, 128), 32, BF16),   # clusters of 8, two channels a rank
    ((2, 1024, 8, 8), 32, BF16),      # one CTA, a warp's chunk 4 channels
    ((2, 96, 16, 16), 32, F32),       # 3 channels a group
    ((1, 32, 8, 8), 8, F32),          # the CPU tests' tiny UNet
])
def test_bwd_onepass_emulation_matches_closed_form(shape, G, dtype):
    """The kernel's split of the work, emulated, gives the closed form's
    gradients: fp32 sums in another order, each within 1e-5 of its scale
    (dx in bf16: one ulp more)."""
    B, C, H, W = shape
    plan = gn_bwd_plan(B, C, G, H * W, dtype)
    assert plan.path == "onepass"
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    gamma = torch.rand(C, generator=g) + 0.5
    beta = torch.randn(C, generator=g) * 0.1
    gy = torch.randn(shape, generator=g).to(dtype)
    got = _emulate_bwd_onepass(x, gamma, beta, gy, G, 1e-5, plan)
    ref = gn_swish_backward_reference(x, gamma, beta, gy, G)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, ref):
        scale = float(b.abs().max())
        rtol = 8e-3 if (name == "dx" and dtype == BF16) else 0.0
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=1e-5 * scale, msg=name)
