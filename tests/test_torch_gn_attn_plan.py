"""The plans of the one-pass GN+Swish and tensor-core attention kernels on
the CPU (``gn_plan``, ``attn_plan``), and torch
emulations of the two kernels' cluster arithmetic — which CTA of a cluster
holds which part of the work, and the order in which the cluster's partial
sums are added — held against the JAX package's Pallas kernels in
interpret mode.  The kernels themselves are held to their plain versions
on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sr3d_torch.kernels.attention import SLICE, attn_plan
from sr3d_torch.kernels.groupnorm_swish import (
    GN_CTA_BYTES,
    GN_THREADS,
    gn_plan,
)
from sr3d_tpu.kernels.attention import _attn_pallas
from sr3d_tpu.kernels.groupnorm_swish import _gn_swish_pallas

torch.set_num_threads(1)
BF16, F32 = torch.bfloat16, torch.float32
QUERY_TILE = 64  # query rows of one CTA of attn_mma_kernel

# The kernels' split of the work, restated from csrc/groupnorm_swish.cu
# (gn_swish_onepass_kernel) and csrc/attention.cu (attn_mma_kernel).


def _rank_vectors(plan, rank: int) -> tuple[int, int]:
    """The 16-byte vectors ``[lo, hi)`` of a group that cluster rank
    ``rank`` of the one-pass GN kernel holds: ``[n·r/S, n·(r+1)/S)``."""
    n, s = plan.group_vectors, plan.cluster
    return n * rank // s, n * (rank + 1) // s


def _cluster_slices(C: int, cluster: int) -> list[list[tuple[int, int]]]:
    """The channel ranges ``[lo, hi)`` each rank of an attention cluster
    owns: rank r takes 64-channel slices r, r + cluster, ..."""
    n = -(-C // SLICE)
    return [[(s * SLICE, min(C, (s + 1) * SLICE))
             for s in range(r, n, cluster)] for r in range(cluster)]


def _cluster_rows(cluster: int) -> list[tuple[int, int]]:
    """The query rows ``[lo, hi)`` of a 64-row tile whose scores each rank
    of an attention cluster reduces and whose softmax it computes."""
    return [(r * QUERY_TILE // cluster, (r + 1) * QUERY_TILE // cluster)
            for r in range(cluster)]


def _flagship_gn_shapes(monkeypatch) -> list[tuple[int, int]]:
    """(C, H·W) of every GN+Swish call of one forward of the 16→128
    UNet (``configs/sr_sr3_VGGF2_16_128_model2.yml``), traced on the meta
    device: no memory, no arithmetic."""
    import sr3d_torch.models.sr3_unet as unet_mod

    seen = []

    def record(x, gamma, beta, groups, eps=1e-5):
        seen.append((x.shape[1], x.shape[2] * x.shape[3]))
        return x

    monkeypatch.setattr(unet_mod, "gn_swish", record)
    monkeypatch.setattr(unet_mod, "spatial_attention",
                        lambda q, k, v, channels=None: q)
    with torch.device("meta"), torch.no_grad():
        unet = unet_mod.SR3UNet(inner_channel=64, norm_groups=32,
                                channel_mults=(1, 2, 4, 8, 8),
                                attn_res=(16,), res_blocks=2,
                                image_size=224).eval()
        unet(torch.zeros(1, 6, 128, 128), torch.zeros(1, 1))
    return seen


def _vector_owners(plan) -> np.ndarray:
    """How often the one-pass kernel's index arithmetic touches each of a
    group's 16-byte vectors: rank r copies [lo, hi) into shared memory and
    its thread t takes vectors lo + t + i·T of them, i = 0, 1, ..."""
    hits = np.zeros(plan.group_vectors, np.int64)
    for r in range(plan.cluster):
        lo, hi = _rank_vectors(plan, r)
        steps = -(-(hi - lo) // plan.threads)
        idx = (lo + np.arange(plan.threads)[:, None]
               + plan.threads * np.arange(steps)[None, :]).ravel()
        np.add.at(hits, idx[idx < hi], 1)
    return hits


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_gn_plan_takes_every_flagship_shape_in_one_pass(monkeypatch, B,
                                                         dtype):
    shapes = _flagship_gn_shapes(monkeypatch)
    assert len(shapes) == 55
    for C, HW in sorted(set(shapes)):
        plan = gn_plan(B, C, 32, HW, dtype)
        assert plan.path == "onepass", (C, HW, plan.why)
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.threads % 32 == 0 and plan.threads <= GN_THREADS
        assert 16 * -(-plan.group_vectors // plan.cluster) <= GN_CTA_BYTES
        assert 16 * plan.group_vectors == C // 32 * HW * (
            2 if dtype == BF16 else 4)
        assert (_vector_owners(plan) == 1).all(), (C, HW)


def test_gn_plan_fills_the_card_and_keeps_other_shapes_two_pass():
    # B = 1 at 128² × 64: 32 groups; clusters of 8 give 256 CTAs
    assert gn_plan(1, 64, 32, 128 * 128, BF16).cluster == 8
    # B = 8 at 8² × 512: 256 groups fill the card without a cluster
    assert gn_plan(8, 512, 32, 64, BF16).cluster == 1
    # H·W = 35: no 16-byte vectors
    p = gn_plan(1, 16, 4, 35, BF16)
    assert p.path == "two_pass" and "not a multiple" in p.why
    # 16 channels of 128² in fp32 (1 MB): more than 8 CTAs hold
    p = gn_plan(1, 512, 32, 128 * 128, F32)
    assert p.path == "two_pass" and "exceeds" in p.why


def _emulate_gn_onepass(x, gamma, beta, groups, eps, plan):
    """The one-pass kernel's statistics in torch (fp32, NCHW): each
    cluster rank sums its contiguous share of the group's vectors, the
    cluster adds the partials in rank order; then ``(x − mean)·(rstd·γ) +
    β`` and swish."""
    B, C, H, W = x.shape
    value_bytes = plan.group_vectors * 16 // (C // groups * H * W)
    xg = x.reshape(B, groups, -1)
    out = torch.empty_like(xg)
    n = xg.shape[-1]
    for b in range(B):
        for g in range(groups):
            s = torch.zeros((), dtype=torch.float32)
            q = torch.zeros((), dtype=torch.float32)
            for r in range(plan.cluster):
                lo, hi = _rank_vectors(plan, r)
                share = xg[b, g, lo * 16 // value_bytes:
                           hi * 16 // value_bytes]
                s = s + share.sum()
                q = q + (share * share).sum()
            mean = s / n
            var = torch.clamp(q / n - mean * mean, min=0.0)
            rstd = 1.0 / torch.sqrt(var + eps)
            cs = slice(g * (C // groups), (g + 1) * (C // groups))
            a = (rstd * gamma[cs]).repeat_interleave(H * W)
            sh = beta[cs].repeat_interleave(H * W)
            v = (xg[b, g] - mean) * a + sh
            out[b, g] = v * torch.sigmoid(v)
    return out.reshape(B, C, H, W)


@pytest.mark.parametrize("shape,groups,cluster", [
    ((1, 64, 32, 32), 8, 4),   # 8 groups of 8192 values: clusters of 4
    ((2, 32, 64, 64), 8, 8),   # 32 KB a group: clusters of 8
    ((1, 96, 8, 8), 32, 1),    # three channels a group, no cluster
])
def test_gn_onepass_emulation_matches_pallas(shape, groups, cluster):
    """fp32, the Pallas kernel's own tolerance (2e-5)."""
    B, C, H, W = shape
    plan = gn_plan(B, C, groups, H * W, F32)
    assert plan.path == "onepass" and plan.cluster == cluster
    rng = np.random.RandomState(7)
    x = (rng.randn(B, H, W, C) * 2 + 0.5).astype(np.float32)
    gamma = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = _gn_swish_pallas(jnp.asarray(x), jnp.asarray(gamma),
                               jnp.asarray(beta), groups, 1e-5)
    got = _emulate_gn_onepass(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
        torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5, plan)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("HW,C,dtype,want", [
    (64, 512, BF16, ("mma", 8)),    # the 16->128 mid block
    (256, 128, BF16, ("mma", 2)),
    (4, 512, BF16, ("mma", 8)),     # the 16_32 configs' mid block
    (37, 40, BF16, ("mma", 1)),
    (256, 1024, BF16, ("mma", 8)),  # two slices a CTA
    (64, 36, BF16, ("simt", 0)),    # C % 8 != 0
    (64, 512, F32, ("simt", 0)),    # no TF32
    (257, 64, BF16, ("long", 0)),   # past the on-chip score rows
    (1024, 512, BF16, ("long", 0)),  # 256² data at the default attn_res
    (4096, 36, F32, ("long", 0)),
])
def test_attn_plan(HW, C, dtype, want):
    p = attn_plan(HW, C, dtype)
    assert (p.path, p.cluster) == want, p.why


@pytest.mark.parametrize("C", [8, 40, 64, 128, 200, 512, 520, 1024])
def test_attn_cluster_splits_cover_channels_and_rows_once(C):
    cluster = attn_plan(64, C, BF16).cluster
    ranges = sorted(r for rank in _cluster_slices(C, cluster) for r in rank)
    assert all(rank for rank in _cluster_slices(C, cluster))  # none idle
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    rows = _cluster_rows(cluster)
    assert rows[0][0] == 0 and rows[-1][1] == QUERY_TILE
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(rows, rows[1:]))


def _emulate_attn_cluster(q, k, v, scale):
    """The tensor-core kernel's split in torch (fp32): per (query tile,
    image) each cluster rank sums Q_s K_sᵀ over its slices in slice order;
    the owner of a query row adds the ranks' partials in rank order,
    scales, takes the softmax over the valid keys and rounds P to v's
    type; each rank computes P V_s for its slices."""
    B, HW, C = q.shape
    cluster = attn_plan(HW, C, BF16).cluster
    slices = _cluster_slices(C, cluster)
    out = torch.zeros(B, HW, C)
    for b in range(B):
        for q0 in range(0, HW, QUERY_TILE):
            qt = torch.zeros(QUERY_TILE, C)
            rows = min(QUERY_TILE, HW - q0)
            qt[:rows] = q[b, q0:q0 + rows]
            parts = []
            for mine in slices:
                part = torch.zeros(QUERY_TILE, HW)
                for lo, hi in mine:
                    part = part + qt[:, lo:hi] @ k[b, :, lo:hi].t()
                parts.append(part)
            p = torch.empty(QUERY_TILE, HW)
            for r0, r1 in _cluster_rows(cluster):
                s = parts[0][r0:r1]
                for part in parts[1:]:
                    s = s + part[r0:r1]
                p[r0:r1] = torch.softmax(s * scale, dim=-1)
            p = p.to(v.dtype).float()
            for mine in slices:
                for lo, hi in mine:
                    out[b, q0:q0 + rows, lo:hi] = \
                        (p @ v[b, :, lo:hi].float())[:rows]
    return out.to(q.dtype)


@pytest.mark.parametrize("shape", [
    (2, 64, 128),   # clusters of 2
    (1, 37, 200),   # a ragged query tile and last slice, clusters of 4
    (1, 70, 520),   # two query tiles, clusters of 8, rank 0 with 2 slices
])
def test_attn_cluster_emulation_matches_pallas(shape):
    """fp32, the Pallas kernel's own tolerance (1e-5)."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / float(np.sqrt(shape[-1]))
    with pltpu.force_tpu_interpret_mode():
        ref = _attn_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale)
    got = _emulate_attn_cluster(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


LONG_KEYS = 32  # keys per tile of attn_long_kernel


def _emulate_attn_long(q, k, v, scale):
    """attn_long_kernel's arithmetic in torch: pass 1 keeps each row's
    running max m and sum l = Σ exp(s − m) over 32-key tiles, rescaling l
    when m grows; pass 2 forms P = exp(s − m) / l per tile, rounds it to
    v's type and adds P V in key order."""
    B, HW, C = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, HW, 1), -float("inf"))
    l = torch.zeros(B, HW, 1)
    tiles = range(0, HW, LONG_KEYS)
    for k0 in tiles:
        s = qf @ kf[:, k0:k0 + LONG_KEYS].transpose(1, 2) * scale
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    out = torch.zeros(B, HW, C)
    for k0 in tiles:
        s = qf @ kf[:, k0:k0 + LONG_KEYS].transpose(1, 2) * scale
        p = (torch.exp(s - m) / l).to(v.dtype).float()
        out = out + p @ vf[:, k0:k0 + LONG_KEYS]
    return out.to(q.dtype)


@pytest.mark.parametrize("shape", [(1, 300, 40), (2, 257, 64)])
def test_attn_long_emulation_matches_pallas(shape):
    """The long path's two passes (online max and sum, then P rounded
    after the division, as the TPU kernel rounds it) against the Pallas
    kernel in interpret mode, fp32, its own tolerance (1e-5)."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / float(np.sqrt(shape[-1]))
    with pltpu.force_tpu_interpret_mode():
        ref = _attn_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale)
    got = _emulate_attn_long(*(torch.from_numpy(a) for a in (q, k, v)),
                             scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
