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
    (256, 512, BF16, ("mma", 8)),   # 129-256 tokens stay on attn_mma_kernel
    (129, 64, BF16, ("mma", 1)),
    (64, 36, BF16, ("simt", 1)),    # C % 8 != 0: the tiled kernel
    (16, 100, BF16, ("simt", 2)),
    (64, 512, F32, ("simt", 8)),    # fp32: the tiled kernel in 3xTF32
    (256, 128, F32, ("simt", 2)),
    (1, 9, F32, ("simt", 1)),
    (257, 64, BF16, ("long", 1)),   # past the on-chip score rows
    (1024, 512, BF16, ("long", 8)),  # 256² data at the default attn_res
    (4096, 512, BF16, ("long", 8)),  # 512² data
    (2049, 1032, BF16, ("long", 8)),  # 17 slices: more than one a rank
    (4096, 36, F32, ("long", 1)),
    (300, 40, F32, ("long", 1)),
])
def test_attn_plan(HW, C, dtype, want):
    p = attn_plan(HW, C, dtype)
    assert (p.path, p.cluster) == want, p.why
    if p.path != "mma":
        assert ("3xTF32" in p.why) == (dtype == F32), p.why


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


# attn_tiled_kernel (plan paths long and simt), restated from
# csrc/attention.cu: 64-key tiles, 64 query rows a cluster, rank r of S
# owning the rows [ceil(64 r / S), ceil(64 (r + 1) / S))
TILE_KEYS = 64
TILED_ROWS = 64
RING = 3  # K and V tiles in flight


def _tiled_rows(QT: int, S: int) -> list[tuple[int, int]]:
    return [(-(-QT * r // S), -(-QT * (r + 1) // S)) for r in range(S)]


@pytest.mark.parametrize("QT", [TILED_ROWS, 128])
@pytest.mark.parametrize("S", range(1, 9))
def test_attn_tiled_rows_cover_the_tile_once(QT, S):
    """Each row of a query tile has one owner, found from the row as the
    kernel finds it (``row·S / QT``), and fits the owner's receive buffer
    (``ceil(QT / S)`` rows a source rank)."""
    rows = _tiled_rows(QT, S)
    assert rows[0][0] == 0 and rows[-1][1] == QT
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    rpr = -(-QT // S)
    for r, (lo, hi) in enumerate(rows):
        assert 0 < hi - lo <= rpr
        assert all(row * S // QT == r for row in range(lo, hi))


def _tiled_schedule(T: int, rounds: int, multi: bool) -> None:
    """Replay the slots of attn_tiled_kernel's loop and check that every
    read finds the tile it wants, visible, and that no write lands on a
    slot whose old tile may still be read.  Iteration u runs from u = -1
    to NU + 1 (NU = T·(1 + rounds)); time 2u + 2 is its top (after the
    cluster barrier's wait: loads issued, partials and P pushed, the
    partials of tile u - 1 and P of tile u - 2 read), time 2u + 3 its
    bottom (after the arrive, ``cp.async.wait_group 2`` and
    ``__syncthreads``: K of tile u + 1 read).  A cp.async issued at time
    t is visible from t + 3 (the next bottom); a DSMEM push at a top from
    the next top; a write at time t is safe against reads up to t - 2 (a
    top's writes wait for every thread's arrive at the previous
    iteration; the previous bottom runs beside them)."""
    NU = T * (1 + rounds)
    slots: dict = {}

    def write(buf, slot, tile, t, visible):
        old = slots.get((buf, slot))
        if old is not None:
            assert old["last_read"] <= t - 2, (buf, slot, old, tile, t)
        slots[(buf, slot)] = {"tile": tile, "from": visible, "last_read": -9}

    def read(buf, slot, tile, t):
        s = slots[(buf, slot)]
        assert s["tile"] == tile and s["from"] <= t, (buf, slot, s, tile, t)
        s["last_read"] = t

    if not multi:
        write("K", 0, 0, -2, 1)      # the prologue: K of tile 0
    for u in range(-1, NU + 2):
        top, bottom = 2 * u + 2, 2 * u + 3
        if T <= u < NU:
            write("V", u % RING, u, top, top + 3)
        if not multi and u + 2 < NU:
            write("K", (u + 2) % RING, u + 2, top, top + 3)
        if 0 <= u < NU:
            write("R", u & 1, u, top, top + 2)
        if 1 <= u <= NU:
            read("R", (u - 1) & 1, u - 1, top)
            if u - 1 >= T:
                write("P", (u - 1) & 1, u - 1, top, top + 2)
        if u - 2 >= T:
            read("P", (u - 2) & 1, u - 2, top)
            read("V", (u - 2) % RING, u - 2, top)
        if u + 1 < NU and not multi:
            read("K", (u + 1) % RING, u + 1, bottom)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 33])
@pytest.mark.parametrize("rounds,multi", [(1, False), (2, True),
                                          (3, True)])
def test_attn_tiled_schedule_reads_what_it_wants(T, rounds, multi):
    _tiled_schedule(T, rounds, multi)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds it."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, tf32x3: bool) -> torch.Tensor:
    """``a @ b`` in fp32; in 3xTF32, each operand split into a TF32 hi and
    lo and a_lo b_hi + a_hi b_lo + a_hi b_hi summed (a_lo b_lo dropped)."""
    if not tf32x3:
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulate_attn_tiled(q, k, v, scale):
    """attn_tiled_kernel's arithmetic in torch (bf16 inputs: exact fp32
    products; fp32: 3xTF32): per 32-key tile each cluster rank sums Q_s
    K_sᵀ over its 64-channel slices in slice order, the owner of a row adds
    the ranks' partials in rank order and scales them; pass 1 keeps the
    running max m and sum l = Σ exp(s − m) (rescaled when m grows), pass 2
    forms P = exp(s − m) / l per tile, rounds it to v's type after the
    division and adds P V in key-tile order."""
    B, HW, C = q.shape
    tf32x3 = q.dtype == F32
    cluster = attn_plan(HW, C, q.dtype).cluster
    slices = _cluster_slices(C, cluster)
    qf, kf, vf = q.float(), k.float(), v.float()
    tiles = [(k0, min(HW, k0 + TILE_KEYS)) for k0 in range(0, HW, TILE_KEYS)]

    def scores(k0, k1):
        parts = []
        for mine in slices:
            part = torch.zeros(B, HW, k1 - k0)
            for lo, hi in mine:
                part = part + _product(qf[..., lo:hi],
                                       kf[:, k0:k1, lo:hi].transpose(1, 2),
                                       tf32x3)
            parts.append(part)
        s = parts[0]
        for part in parts[1:]:
            s = s + part
        return s * scale

    m = torch.full((B, HW, 1), -float("inf"))
    l = torch.zeros(B, HW, 1)
    for k0, k1 in tiles:
        s = scores(k0, k1)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    out = torch.zeros(B, HW, C)
    for k0, k1 in tiles:
        p = (torch.exp(scores(k0, k1) - m) / l).to(v.dtype).float()
        out = out + _product(p, vf[:, k0:k1], tf32x3)
    return out.to(q.dtype)


def _pallas_and_tiled(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(dtype) for _ in range(3))
    scale = 1.0 / float(np.sqrt(shape[-1]))
    with pltpu.force_tpu_interpret_mode():
        ref = _attn_pallas(*(jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if dtype == BF16 else jnp.float32)
            for t in (q, k, v)), scale)
    got = _emulate_attn_tiled(q, k, v, scale)
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("shape,dtype", [
    ((1, 300, 40), F32),    # a ragged last tile, C not a multiple of 64
    ((2, 257, 64), F32),    # one key past a tile
    ((1, 520, 72), F32),    # two slices: clusters of 2
    ((1, 300, 40), BF16),
    ((1, 288, 600), BF16),  # 10 slices over 8 ranks: rank 0 and 1 have two
])
def test_attn_long_emulation_matches_pallas(shape, dtype):
    """The long path's two passes (online max and sum, then P rounded
    after the division, as the TPU kernel rounds it) against the Pallas
    kernel in interpret mode: fp32 in 3xTF32 at the Pallas kernel's own
    tolerance (1e-5), bf16 at one bf16 ulp of the output."""
    assert attn_plan(shape[1], shape[2], dtype).path == "long"
    got, ref = _pallas_and_tiled(shape, dtype, 4)
    tol = dict(atol=1e-5) if dtype == F32 else dict(atol=2e-2, rtol=8e-3)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 64, 128), F32),    # the mid block's tokens, clusters of 2
    ((1, 37, 200), F32),    # a ragged tile and last slice, clusters of 4
    ((1, 70, 520), F32),    # 9 slices: rank 0 has two
    ((1, 4, 9), F32),       # C % 4 != 0: loads an element at a time
    ((2, 16, 36), BF16),    # C % 8 != 0
    ((1, 45, 100), BF16),
])
def test_attn_simt_emulation_matches_pallas(shape, dtype):
    """The simt path (fp32 in 3xTF32, bf16 with C % 8 != 0) is the tiled
    kernel at <= 256 tokens: against the Pallas kernel in interpret mode,
    fp32 at 1e-5 (3xTF32 drops only a_lo b_lo, ~2^-22 of a product),
    bf16 at one bf16 ulp."""
    assert attn_plan(shape[1], shape[2], dtype).path == "simt"
    got, ref = _pallas_and_tiled(shape, dtype, 5)
    tol = dict(atol=1e-5) if dtype == F32 else dict(atol=2e-2, rtol=8e-3)
    np.testing.assert_allclose(got, ref, **tol)


def test_tf32_split_keeps_fp32_accuracy_where_tf32_alone_does_not():
    """3xTF32 products of fp32 sums stay within ~1e-6 of fp64 where TF32
    alone is ~1e-3 off: why the fp32 path may use the tensor cores only
    this way."""
    rng = np.random.RandomState(6)
    a = torch.from_numpy(rng.randn(64, 512).astype(np.float32))
    b = torch.from_numpy(rng.randn(512, 64).astype(np.float32))
    exact = a.double() @ b.double()
    e3 = float((_product(a, b, True).double() - exact).abs().max())
    e1 = float((_tf32(a) @ _tf32(b) - exact).abs().max())
    assert e3 < 1e-4 < 1e-2 < e1, (e3, e1)
