#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, and the tools
around them, on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for the fp32 checks;
2. build: compile the CUDA kernels from ``sr3d_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version at the flagship
   UNet's shapes (GN+Swish at one width of each level and two stats + apply
   shapes; attention at the mid block, B = 8, 4, 2 and 1, and past 256 tokens,
   1024 and 4096), bf16 and fp32, with its time, the plain version's, one
   PyTorch library call's for the same function (a yardstick the port never
   calls) and the card's bound for the work; GN+Swish also at every other
   input of the main paths (a meta-device trace of the UNet at B = 8, 4,
   2, 1), bf16, checked and timed against the library call; each shape's plan
   (GN: one pass over a cluster or stats + apply; attention: all score rows
   on chip (mma) or two passes over key tiles (long, simt), each over a
   cluster; conv: tensor or CUDA cores, split K), bit-equal repeats of the
   cluster reductions, and the tensor-core instructions in the built
   attention (in both instantiations of its tiled kernel too), conv and
   int8 conv libraries (HGMMA, HMMA, IGMMA and IMMA); one bf16 forward of
   a flagship-width UNet with the module's default attention gate on 256²
   inputs (five long-path launches at 1024 tokens) against the same
   forward with the plain attention, both timed; the int8 conv bit for bit at every
   distinct int8 conv of the serving CLI's UNet forward (a meta-device
   trace, B = 8, bf16; its tensor-core path, the plan printed), in fp32 at
   both strides and scale kinds, at shapes of its first-version path and
   at the 8->32 UNet's short-row convs (its short-row path),
   timed on the cached path (weights quantized beforehand) and cold
   against im2col + ``torch._int_mm`` and cuDNN's bf16 conv; GN+Swish,
   attention and the int8 conv at every other shape of every
   ``configs/*.yml`` UNet (a meta-device trace at B = 8, 4, 2, 1: H·W down
   to 1, attention at 64, 16, 4 and 1 tokens) and at the flagship's
   spatial bands over 2 and 4 ranks (the band GN as stats + the apply
   kernel with the whole image's count; the int8 convs on a band and its
   halo), checks only; the GN+Swish backward kernels (``gn_swish_backward``)
   against their closed form and autograd of the plain version at the
   widest training input ([4, 192, 128, 128]) and at B = 8, bf16 and fp32,
   timed against the closed form, the backward alone of autograd through
   ``F.silu(F.group_norm)`` and the bound, bit-equal repeats on both plan
   paths (one pass over a cluster; three passes), then at every GN input
   of the training paths (the flagship's and the DDPM family's UNet in
   train mode and every ``configs/*.yml`` UNet at B = 4, 2, 1), checks
   only; the GN+Swish and attention gradients against autograd
   of their plain versions; then the whole serving step and one whole train
   step (model2, then model3 flow-through) on a tiny config, on the GPU
   against the plain versions on the CPU, and model3's gradients on the GPU
   with the hand-off's per-step checkpoints on and off;
4. serving, DDIM-25 (η=1, marginal init) at the full width of
   ``configs/sr_sr3_VGGF2_16_128_model2.yml``, bf16, random weights from
   seed 0, synthetic FLAME at the real size: two requests (8 faces, then 3
   with a padded tail), then one of 8 with DPM-Solver++(2M) (25 steps,
   η=0, marginal init); outputs checked, kernel launches counted;
5. serving, the ancestral loop at the config's T=600, one face;
6. training, the model2 joint train step at the same full width (N = K×B
   = 4 synthetic faces, 16→128, remat, Adam/AdamW, EMA): three
   steps with the DDIM-25 hand-off, then one with the config's T=600
   ancestral hand-off; losses, parameter updates, the frozen prefix, the
   EMA, step times, peak memory and kernel launches checked;
7. training, the model3 joint train step at the full width of
   ``configs/sr_sr3_VGGF2_16_128_model3.yml`` (the same network, the
   differentiable hand-off checkpointed per sampling step): three
   flow-through steps with the DDIM-25 hand-off, the hand-off's forward
   and backward alone, one flow-through step with the T=600 ancestral
   hand-off, and one severed step from the first step's state and draws
   (the same losses and MICA-branch updates, another UNet update); step
   times, peak memory, the frozen prefix and kernel launches checked;
8. checkpoints: a train state in the JAX package's ``.npz`` layout (random
   weights, seed 0, the EMA seed 1) and a converted UNet, served with
   ``Predictor.from_config(checkpoint=...)`` with and without the EMA, bit
   for bit as the same weights served through ``params=``; load times;
9. the serving CLI, ``sr3d_torch.serve.main``, on the flagship config with
   that checkpoint over 11 synthetic 16² PNGs (DDIM-25, batch 8): the int8
   default (58 int8 convs a forward) and ``--int8 0``, every bundle
   checked, the PSNR between them; the kernels one UNet forward launches
   in each mode (torch.profiler); then int8 and bf16 requests of 8 in
   turns, three each, their median times, no weight quantized during
   them;
10. the joint Trainer through the training CLI (``sr3d_torch.cli.main``)
   at the flagship's full width on a synthetic joint root: 4 steps,
   a resume to step 6, ``-p val``, then the port's own checkpoint served;
   the JAX Trainer's files, the rotated checkpoints (no temporary file),
   the resume, finite losses and the kernels launched checked; s/step,
   the loader-wait share, each background checkpoint's blocking and
   writer times and size, read times, val s/face and peak memory
   printed; (b) a background save at full width (``grad_accum`` 2) with
   train steps run in place while it is written: the file equal leaf for
   leaf to a synchronous save of the state at ``save``, the control (a
   save after the steps) different, the s/step of the steps that overlap
   the write against those that do not;
11. the staged workflow's branch trainers at the same full width, on phase
   10's data: SR-only pretraining through ``cli.main --sr-only`` (16 → 128
   faces, batch 2, 4 steps and a resume to 6), the joint Trainer
   warm-started from its pair (2 steps), the DDPM family (2 ``SRModel``
   steps at B = 2, a DDIM-25 request of 8), ``MicaTrainer.fit`` with its
   ``Validator`` (4 steps and a resume to 6), the alternating trainer
   through ``cli.main --legacy`` (3 DDIM-25 steps, then a resumed T=600
   step); files, counters, finite losses, moved parameters and each call's
   launches checked; s/step, peak memory and the pairs' sizes and write /
   read times printed;
12. the tools around those paths at the same full widths: a
   reference-layout asset tree (iResNet-100 ``backbone.pth``, the UNet's
   ``I100_E5_gen.pth`` + ``_opt.pth``, a MICA ``.tar``, FLAME2020 at 5023
   vertices) through ``python -m sr3d_torch.utils.bootstrap`` and
   ``--check`` (a flipped byte caught), the converted UNet served through
   the serving CLI (a request of 8, DDIM-25, int8) and bit-equal to the
   same weights through ``params=``, the converted ArcFace loaded; the NoW
   runner's dry run (4 subjects x 2) and a run with phase 10's
   checkpoint, Stirling on 4 HQ + 4 LQ pictures; ``data/prepare.py
   --srpk`` and ``data/creation.py --raw-root`` on 16 rendered faces, a
   batch of each onto the card; their times printed;
13. the parallel layer (``sr3d_torch/parallel``) with 2 ranks, each its
   own process, sharing the one card over ``gloo`` (NCCL takes one card
   a rank): the collectives on CUDA tensors; (a) ``Predictor(mesh=)`` at
   the flagship config, DDIM-25, a request of 8 over the ranks' rows, bf16
   and int8, and one UNet forward of each; (b) ``Predictor(mesh=,
   spatial=True)``, a request of 2 with the 128 rows split 64 + 64 (the
   band GN held to ``gn_swish_reference`` at every GN shape of the path
   first); (c) the joint Trainer through the CLI at mesh [2, 1], 3 steps;
   (d) at mesh [1, 2] (tensor parallel, tp_min_channels 128), 2 steps;
   each against one process on the same weights, draws and data, within
   ``PAR_*_TOL``; the checkpoints written by rank 0 alone in the
   one-process layout, held to one process's leaf for leaf
   (``PAR_CKPT_*``), one loaded by one process; a per-rank control on
   each path, which must fail its check: the int8 scale per rank,
   GroupNorm's moments per band, no gradient averaging, the split
   weights gathered in reverse order; per path its seconds,
   each rank's launches and peak memory, labelled as 2 ranks sharing one
   H100 over gloo (overhead, not scaling).

Every training phase (6, 7, 10, 11, 13 (c) and (d)) requires that it
launched ``gn_swish_backward`` and called GN+Swish's plain version (the
forward or the backward's closed form) no time on the card
(``watch_plain_gn``).

The line before the last lists the kernels as JSON (top-level numbers at
the widest main-path shape in bf16, the shapes above under ``shapes``,
GN+Swish's slowest shape against the library call under ``main_path``;
``launches`` from phase 4's DDIM-25 requests (``serving_launches``), but
the int8 conv's from phase 9's int8 CLI run, its main path, and
``gn_swish_backward``'s from phase 6's three train steps (its top-level
numbers at [4, 192, 128, 128]); ``cli_launches`` from that run,
``train_launches`` from phase 6's three steps, ``model3_launches`` from
phase 7's three, ``trainer_launches`` from phase 10, ``sr_only_launches``
from phase 11's SR-only CLI calls, ``legacy_launches`` from its
``--legacy`` calls, ``tools_launches`` from phase 12's served request,
``parallel_launches`` from phase 13's four paths, summed over the ranks,
which are also gn_stats's ``launches``: the spatial request is its path;
``repo_config_shapes``: the shapes phase 3 checked beyond the flagship's);
the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
and when the repository's ``sr3d_torch`` package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12,  # dense bf16 tensor-core rate
            torch.float32: 67e12,    # fp32 outside the tensor cores
            torch.int8: 1979e12}     # dense int8 tensor-core rate
CONFIG = ROOT / "configs" / "sr_sr3_VGGF2_16_128_model2.yml"
MODEL3 = ROOT / "configs" / "sr_sr3_VGGF2_16_128_model3.yml"
TINY = ROOT / "configs" / "tiny_8_16_model2.yml"
GN_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 8e-3)}
ATTN_TOL = GN_TOL
# dγ and dβ of the GN+Swish backward are fp32 sums of B·H·W terms (in any
# input dtype), each term rounded differently (__expf, other orders), so
# their error grows with the sum: atol (times the gradient's largest
# entry) and rtol
GN_BWD_SUM_TOL = (2e-5, 1e-5)
# the conv kernels sum 9·C products in another order than cuDNN's fp32
# convolution (TF32 off): ~1e-6 relative; bf16 outputs: one bf16 ulp
CONV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 8e-3)}


def require(ok, what) -> None:
    """A check that stays on under ``python -O``."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# calls of GN+Swish's plain versions (the forward, and the backward's closed
# form) on CUDA tensors, counted once ``watch_plain_gn`` is installed: a
# path on the card must make none
PLAIN_GN = {"calls": 0}


def watch_plain_gn() -> None:
    """Count every call of ``gn_swish_reference`` and
    ``gn_swish_backward_reference`` on a CUDA tensor in ``PLAIN_GN`` (the
    module globals through which the wrappers reach them; once a
    process)."""
    import sr3d_torch.kernels.groupnorm_swish as gn

    for name in ("gn_swish_reference", "gn_swish_backward_reference"):
        fn = getattr(gn, name)
        if getattr(fn, "watched", False):
            continue

        def counted(x, *a, _fn=fn, **k):
            if x.is_cuda:
                PLAIN_GN["calls"] += 1
            return _fn(x, *a, **k)

        counted.watched = True
        setattr(gn, name, counted)


def require_gn_backward(counts: dict, plain0: int, what: str) -> None:
    """A training path on the card launched the GN+Swish backward kernel
    and ran GN+Swish's plain version (forward or backward) no time since
    ``PLAIN_GN["calls"]`` was ``plain0``."""
    require(counts["gn_swish_backward"] > 0,
            f"{what}: no gn_swish_backward launch: {counts}")
    require(PLAIN_GN["calls"] == plain0,
            f"{what}: GN+Swish's plain version ran on the card "
            f"{PLAIN_GN['calls'] - plain0} times")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed between CUDA events, so the host's launch overhead is
    not in the number.  ``fn`` cycles its inputs (see ``_rotating``) so
    repeated calls do not all hit L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def kernels_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` call without a CUDA graph (autograd's
    backward of a forward that ran outside the clock, which a graph cannot
    replay): the durations of the kernels of ``reps`` calls under
    ``torch.profiler``, summed, over ``reps``.  Like ``device_ms`` it
    leaves out the host's launch gaps (and, unlike it, the device's few
    microseconds between kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from sr3d_torch.profile_train import _device_us

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def _rotating(make, nbytes: int):
    """Enough copies of an input set to exceed the 50 MB L2 (at most 64),
    and a function returning them in turn."""
    n = max(2, min(64, math.ceil(128e6 / max(nbytes, 1))))
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return sets[state["i"]]

    return sets[0], nxt


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# GN+Swish in bf16 and fp32, each with its own record: one width of each of
# the 16->128 UNet's levels at B = 8, the T=600 path's B = 1, and two shapes
# the plan gives the stats + apply pair (H·W = 50: no 16-byte vectors; in
# fp32 a group of 1 MB, more than a cluster of 8 holds).  Every other GN
# input of the main paths is checked and timed in bf16 after these
# (``main_path_gn_shapes``).
GN_SHAPES = ((8, 192, 128, 128), (8, 64, 128, 128), (8, 384, 64, 64),
             (8, 768, 32, 32), (8, 1024, 16, 16), (8, 1024, 8, 8),
             (8, 512, 8, 8), (1, 64, 128, 128), (2, 64, 5, 10),
             (1, 512, 128, 128))
# the mid block at B = 8, 4 (training) , 2 (SR-only training) and 1, a
# 16² attention level (no repo config has one), the 16_32 configs' mid
# block (4 tokens); past the 256 tokens the tensor-core kernel holds, the
# long path: the default attn_res (16) over 256² data (1024 tokens) and
# over 512² data (4096)
ATTN_SHAPES = ((8, 64, 512), (4, 64, 512), (2, 64, 512), (1, 64, 512),
               (2, 256, 128), (8, 4, 512), (8, 1024, 512), (1, 4096, 512))
# DDIM-25 serving, joint training, SR-only training, T=600 serving
MAIN_PATH_BATCHES = (8, 4, 2, 1)


def main_path_gn_shapes() -> list[tuple[int, int, int, int]]:
    """(B, C, H, W) of every distinct GN+Swish input of the main paths: one
    forward of the flagship UNet traced on the meta device (no memory, no
    arithmetic), at each batch size of ``MAIN_PATH_BATCHES``."""
    import sr3d_torch.models.sr3_unet as unet_mod

    cfg = serving_cfg("ddim")
    seen: set = set()

    def record(x, gamma, beta, groups, eps=1e-5):
        seen.add(tuple(x.shape[1:]))
        return x

    saved = unet_mod.gn_swish, unet_mod.spatial_attention
    unet_mod.gn_swish = record
    unet_mod.spatial_attention = lambda q, k, v, channels=None: q
    try:
        with torch.device("meta"), torch.no_grad():
            unet = unet_mod.unet_from_config(cfg.sr.model.unet,
                                             cfg.sr.model.diffusion)
            unet(torch.zeros(1, int(cfg.sr.model.unet.in_channel), 128, 128),
                 torch.zeros(1, 1))
    finally:
        unet_mod.gn_swish, unet_mod.spatial_attention = saved
    return [(B, *chw) for B in MAIN_PATH_BATCHES
            for chw in sorted(seen, reverse=True)]


# the GN+Swish backward, timed: the widest training input (the joint step's
# N = 4 at 128² × 192) and at B = 8; then two shapes of the multi-pass
# plan (H·W = 50: no 16-byte vectors; in fp32 a group of x and gy beyond a
# cluster), checked
GN_BWD_SHAPES = ((4, 192, 128, 128), (8, 192, 128, 128))
GN_BWD_MULTIPASS = ((2, 64, 5, 10), (1, 512, 128, 128))
# the joint step and the Trainer (N = 4), SR-only and DDPM training (2), 1
TRAIN_BATCHES = (4, 2, 1)


def train_gn_shapes() -> list[tuple[int, int, int, int, int]]:
    """(B, C, H, W, groups) of every distinct GN+Swish input of the
    training paths: the flagship config's UNet and the DDPM family's
    (``which_model_G: ddpm``) in train mode at the training resolution, and
    every ``configs/*.yml`` UNet (``trace_config``), at each batch size of
    ``TRAIN_BATCHES``; meta-device traces, widest first."""
    import sr3d_torch.models.sr3_unet as unet_mod
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.models.networks import define_g

    seen: set = set()

    def record(x, gamma, beta, groups, eps=1e-5):
        seen.add((*x.shape[1:], groups))
        return x

    cfg = update_cfg(get_cfg_defaults(), str(CONFIG))
    hr = int(cfg.sr.datasets.train.r_resolution)
    saved = unet_mod.gn_swish, unet_mod.spatial_attention
    unet_mod.gn_swish = record
    unet_mod.spatial_attention = lambda q, k, v, channels=None: q
    try:
        for which in ("sr3", "ddpm"):
            cfg.sr.model.which_model_G = which
            with torch.device("meta"), torch.no_grad():
                unet, time_input = define_g(cfg.sr.model, remat=True)
                unet.train()
                unet(torch.zeros(1, int(cfg.sr.model.unet.in_channel), hr,
                                 hr),
                     torch.zeros(1, 1) if time_input == "gamma"
                     else torch.zeros(1))
    finally:
        unet_mod.gn_swish, unet_mod.spatial_attention = saved
    shapes = {(B, *s) for B in TRAIN_BATCHES for s in seen}
    for path in sorted((ROOT / "configs").glob("*.yml")):
        for B in TRAIN_BATCHES:
            shapes |= trace_config(path, B, quant=False)["gn"]
    return sorted(shapes, key=lambda s: (-math.prod(s[:4]), s))


def _gn_bwd_inputs(dev, shape, dtype):
    """Rotating (x, γ, β, gy) sets for the GN+Swish backward at ``shape``."""
    def make(i):
        g = torch.Generator(device=dev).manual_seed(50 + i)
        x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        return (x.to(dtype),
                torch.rand(shape[1], generator=g, device=dev) + 0.5,
                torch.randn(shape[1], generator=g, device=dev) * 0.1,
                torch.randn(shape, generator=g, device=dev).to(dtype))

    return _rotating(make, 2 * math.prod(shape) * (
        2 if dtype == torch.bfloat16 else 4))


def _gn_bwd_check(x, gamma, beta, gy, G) -> tuple[tuple, float]:
    """``gn_swish_backward`` against its closed form and against autograd
    of ``gn_swish_reference`` on the card (dx: ``GN_TOL``; dγ, dβ:
    ``GN_BWD_SUM_TOL`` of their largest entry); returns the kernel's
    gradients and its largest error against the closed form."""
    from sr3d_torch.kernels import gn_swish_backward
    from sr3d_torch.kernels.groupnorm_swish import (
        gn_swish_backward_reference,
        gn_swish_reference,
    )

    got = gn_swish_backward(x, gamma, beta, gy, G)
    ref = gn_swish_backward_reference(x, gamma, beta, gy, G)
    ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    auto = torch.autograd.grad(gn_swish_reference(*ins, G), ins, gy)
    torch.cuda.synchronize()
    err = 0.0
    for what, other in (("closed form", ref), ("autograd", auto)):
        for name, a, b in zip(("dx", "dgamma", "dbeta"), got, other):
            e = float((a.float() - b.float()).abs().max())
            atol, rtol = GN_TOL[x.dtype]
            if name != "dx":
                atol = GN_BWD_SUM_TOL[0] * float(b.abs().max())
                rtol = GN_BWD_SUM_TOL[1]
            require(torch.allclose(a.float(), b.float(), atol=atol,
                                   rtol=rtol),
                    f"gn_swish_backward {name} disagrees with the {what} at "
                    f"{tuple(x.shape)} G={G} {x.dtype}: {e}")
            if what == "closed form":
                err = max(err, e)
    return got, err


def phase_gn_backward(dev) -> dict:
    """The GN+Swish backward kernels (``gn_swish_backward``) against the
    closed form and autograd of the plain version: timed at
    ``GN_BWD_SHAPES`` against the closed form, the backward alone of
    autograd through ``F.silu(F.group_norm)`` and the bound, bf16 and fp32;
    bit-equal repeats on both plan paths; then at every GN input of the
    training paths (bf16, checks only).  Returns its record."""
    import torch.nn.functional as F

    from sr3d_torch.kernels import gn_swish_backward
    from sr3d_torch.kernels.groupnorm_swish import (
        gn_bwd_plan,
        gn_swish_backward_reference,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec: dict = {}
    err = 0.0
    G = 32
    paths: dict = {}

    def library_backward(a, dtype):
        """The forward of F.silu(F.group_norm) outside the clock, and a
        function that runs its backward alone (``kernels_ms``)."""
        ins = [a[0].clone().requires_grad_(),
               a[1].to(dtype).requires_grad_(),
               a[2].to(dtype).requires_grad_()]
        y = F.silu(F.group_norm(ins[0], G, ins[1], ins[2], 1e-5))
        return lambda: torch.autograd.grad(y, ins, a[3], retain_graph=True)

    for dtype in (torch.bfloat16, torch.float32):
        el = 2 if dtype == torch.bfloat16 else 4
        for shape in GN_BWD_SHAPES + GN_BWD_MULTIPASS:
            B, C, H, W = shape
            (x, gamma, beta, gy), nxt = _gn_bwd_inputs(dev, shape, dtype)
            plan = gn_bwd_plan(B, C, G, H * W, dtype, sms)
            paths.setdefault(plan.path, []).append(
                [B, C, H, W, _dtype_name(dtype)])
            got, e = _gn_bwd_check(x, gamma, beta, gy, G)
            err = max(err, e)
            rep = all(all(torch.equal(a, b) for a, b in zip(
                gn_swish_backward(x, gamma, beta, gy, G), got))
                for _ in range(3))
            require(rep, f"gn_swish_backward does not repeat bit for bit at "
                         f"{shape} {dtype} ({plan.path})")
            print(f"  gn backward {_dtype_name(dtype)} x={list(shape)} "
                  f"G={G}: path {plan.path} ({plan.why}); max err vs the "
                  f"closed form {e:.3g} (dx within GN_TOL {GN_TOL[dtype]}, "
                  f"dgamma and dbeta within {GN_BWD_SUM_TOL} of their "
                  f"largest entry), autograd of the plain version too; 3 "
                  f"repeats bit for bit")
            if shape in GN_BWD_MULTIPASS:
                del x, gamma, beta, gy, nxt, got
                continue
            # the backward alone of the library call, on each rotating set
            lib = [library_backward(a, dtype) for a in
                   (nxt() for _ in range(max(2, math.ceil(
                       128e6 / (2 * math.prod(shape) * el)))))]
            it = {"i": 0}

            def lib_next():
                it["i"] = (it["i"] + 1) % len(lib)
                return lib[it["i"]]()

            t = {"ms": device_ms(lambda: gn_swish_backward(*nxt(), G)),
                 "plain_ms": device_ms(
                     lambda: gn_swish_backward_reference(*nxt(), G)),
                 "library_ms": kernels_ms(lib_next)}
            nbytes = 3 * math.prod(shape) * el + 4 * C * 4
            b = bound(nbytes, 20 * math.prod(shape), torch.float32)
            print(f"      kernel {t['ms']:.4f} ms, closed form "
                  f"{t['plain_ms']:.4f}, backward of silu(group_norm) "
                  f"{t['library_ms']:.4f}, bound {b[0]:.4f} ({b[1]}: read "
                  f"x and gy, write dx)")
            _record(rec, "gn_swish_backward",
                    dtype == torch.bfloat16 and shape == GN_BWD_SHAPES[0], {
                        "shape": list(shape), "dtype": _dtype_name(dtype),
                        "path": plan.path, "cluster": plan.cluster, **t,
                        "bound_ms": b[0], "bound_by": b[1]})
            del x, gamma, beta, gy, nxt, got, lib

    # every GN input of the training paths, in their dtype (bf16)
    shapes = train_gn_shapes()
    dtype = torch.bfloat16
    for (B, C, H, W, g) in shapes:
        (x, gamma, beta, gy), _ = _gn_bwd_inputs(dev, (B, C, H, W), dtype)
        plan = gn_bwd_plan(B, C, g, H * W, dtype, sms)
        paths.setdefault(plan.path, []).append([B, C, H, W, "bfloat16"])
        err = max(err, _gn_bwd_check(x, gamma, beta, gy, g)[1])
    require(set(paths) == {"onepass", "multipass"},
            f"a plan path of the backward was not hit: {sorted(paths)}")
    print(f"  gn backward bf16 at all {len(shapes)} GN inputs of the "
          f"training paths (the flagship's UNet and the DDPM family's in "
          f"train mode, every configs/*.yml UNet; B = "
          f"{', '.join(map(str, TRAIN_BATCHES))}; H*W down to "
          f"{min(s[2] * s[3] for s in shapes)}): against the closed form "
          f"and autograd of the plain version (dx within GN_TOL, dgamma "
          f"and dbeta within GN_BWD_SUM_TOL of their scale); paths "
          f"{ {k: len(v) for k, v in paths.items()} } (multi-pass at "
          f"{paths['multipass'][:6]}...)")
    r = rec["gn_swish_backward"]
    r["max_abs_err"] = err
    r["training_shapes"] = len(shapes)
    r["plan_paths"] = {k: len(v) for k, v in paths.items()}
    return rec


def _gn_inputs(dev, shape, dtype):
    """Rotating (x, γ, β) sets for GN+Swish at ``shape`` (see ``_rotating``)."""
    def make(i):
        g = torch.Generator(device=dev).manual_seed(i)
        x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        return (x.to(dtype),
                torch.rand(shape[1], generator=g, device=dev) + 0.5,
                torch.randn(shape[1], generator=g, device=dev) * 0.1)

    return _rotating(make, math.prod(shape) * (2 if dtype == torch.bfloat16
                                               else 4))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _record(rec: dict, name: str, top: bool, row: dict) -> None:
    """Add one shape's row to ``rec[name]``; ``top`` marks the widest
    main-path shape, whose numbers are the kernel's top-level fields."""
    r = rec.setdefault(name, {"shapes": []})
    r["shapes"].append(row)
    if top:
        r.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")})


def phase_kernels(dev) -> dict:
    """GN and attention against their plain versions at ``GN_SHAPES`` and
    ``ATTN_SHAPES`` and GN+Swish at every main-path shape; returns
    per-kernel records (top level: the widest shape, bf16; ``shapes``: each
    listed shape and dtype; ``main_path``: GN+Swish's slowest main-path
    shape against the library call)."""
    import torch.nn.functional as F

    from sr3d_torch.kernels import gn_stats, gn_swish, spatial_attention
    from sr3d_torch.kernels.attention import (
        attn_plan,
        spatial_attention_reference,
    )
    from sr3d_torch.kernels.groupnorm_swish import (
        gn_plan,
        gn_stats_reference,
        gn_swish_reference,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec: dict = {}
    err = {"gn_stats": 0.0, "gn_swish": 0.0, "spatial_attention": 0.0}
    G = 32
    def library(a, dtype):
        return F.silu(F.group_norm(a[0], G, a[1].to(dtype), a[2].to(dtype),
                                   1e-5))

    for dtype in (torch.bfloat16, torch.float32):
        for (B, C, H, W) in GN_SHAPES:
            nx = B * C * H * W * (2 if dtype == torch.bfloat16 else 4)
            (x, gamma, beta), nxt = _gn_inputs(dev, (B, C, H, W), dtype)
            plan = gn_plan(B, C, G, H * W, dtype, sms)
            s, q = gn_stats(x)
            s_ref, q_ref = gn_stats_reference(x)
            torch.cuda.synchronize()
            e_stats = max(float((s - s_ref).abs().max()),
                          float((q - q_ref).abs().max()))
            require(torch.allclose(s, s_ref, rtol=1e-4, atol=1e-3)
                    and torch.allclose(q, q_ref, rtol=1e-4, atol=1e-3),
                    f"gn_stats disagrees at {(B, C, H, W)} {dtype}: "
                    f"{e_stats}")
            y = gn_swish(x, gamma, beta, G)
            y_ref = gn_swish_reference(x, gamma, beta, G)
            torch.cuda.synchronize()
            atol, rtol = GN_TOL[dtype]
            e_gn = float((y.float() - y_ref.float()).abs().max())
            require(torch.allclose(y.float(), y_ref.float(), atol=atol,
                                   rtol=rtol),
                    f"gn_swish disagrees at {(B, C, H, W)} {dtype}: {e_gn}")
            err["gn_stats"] = max(err["gn_stats"], e_stats)
            err["gn_swish"] = max(err["gn_swish"], e_gn)

            t = {
                "gn_stats": device_ms(lambda: gn_stats(nxt()[0])),
                "gn_stats_plain": device_ms(
                    lambda: gn_stats_reference(nxt()[0])),
                "gn_stats_lib": device_ms(lambda: torch.var_mean(
                    nxt()[0], dim=(2, 3), correction=0)),
                "gn_swish": device_ms(lambda: gn_swish(*nxt(), G)),
                "gn_swish_plain": device_ms(
                    lambda: gn_swish_reference(*nxt(), G)),
                "gn_swish_lib": device_ms(lambda: library(nxt(), dtype)),
            }
            b_stats = bound(nx + 2 * B * C * 4, 3 * B * C * H * W,
                            torch.float32)
            b_gn = bound(2 * nx + 2 * C * 4, 12 * B * C * H * W,
                         torch.float32)
            print(f"  gn  {dtype} x={[B, C, H, W]} G={G}: path {plan.path}"
                  f" ({plan.why}); stats err {e_stats:.3g} (rtol 1e-4, "
                  f"atol 1e-3)  gn_swish err {e_gn:.3g} (atol {atol}, rtol "
                  f"{rtol})")
            print(f"      stats kernel {t['gn_stats']:.4f} ms plain "
                  f"{t['gn_stats_plain']:.4f} var_mean "
                  f"{t['gn_stats_lib']:.4f} bound {b_stats[0]:.4f} | "
                  f"gn_swish kernel {t['gn_swish']:.4f} ms plain "
                  f"{t['gn_swish_plain']:.4f} silu(group_norm) "
                  f"{t['gn_swish_lib']:.4f} bound {b_gn[0]:.4f}")
            top = dtype == torch.bfloat16 and (B, C, H) == (8, 192, 128)
            common = {"shape": [B, C, H, W], "dtype": _dtype_name(dtype)}
            _record(rec, "gn_stats", top, {
                **common, "ms": t["gn_stats"],
                "plain_ms": t["gn_stats_plain"],
                "library_ms": t["gn_stats_lib"], "bound_ms": b_stats[0],
                "bound_by": b_stats[1]})
            _record(rec, "gn_swish", top, {
                **common, "path": plan.path, "cluster": plan.cluster,
                "ms": t["gn_swish"], "plain_ms": t["gn_swish_plain"],
                "library_ms": t["gn_swish_lib"], "bound_ms": b_gn[0],
                "bound_by": b_gn[1]})
            if top:   # the cluster adds its partials in rank order
                require(all(torch.equal(gn_swish(x, gamma, beta, G), y)
                            for _ in range(3)),
                        "gn_swish does not repeat bit for bit")
                print(f"      repeats bit for bit (3 runs, clusters of "
                      f"{plan.cluster})")
            del x, gamma, beta, nxt, y, y_ref

    # every other GN+Swish input of the main paths, in their dtype (bf16):
    # checked against the plain version and timed against the library call
    main = main_path_gn_shapes()
    dtype = torch.bfloat16
    atol, rtol = GN_TOL[dtype]
    ratios = [(r["ms"] / r["library_ms"], r["shape"])
              for r in rec["gn_swish"]["shapes"]
              if r["dtype"] == "bfloat16" and tuple(r["shape"]) in main]
    for (B, C, H, W) in main:
        if (B, C, H, W) in GN_SHAPES:
            continue
        (x, gamma, beta), nxt = _gn_inputs(dev, (B, C, H, W), dtype)
        plan = gn_plan(B, C, G, H * W, dtype, sms)
        y = gn_swish(x, gamma, beta, G)
        y_ref = gn_swish_reference(x, gamma, beta, G)
        torch.cuda.synchronize()
        e_gn = float((y.float() - y_ref.float()).abs().max())
        require(torch.allclose(y.float(), y_ref.float(), atol=atol,
                               rtol=rtol),
                f"gn_swish disagrees at {(B, C, H, W)} {dtype}: {e_gn}")
        err["gn_swish"] = max(err["gn_swish"], e_gn)
        t_k = device_ms(lambda: gn_swish(*nxt(), G))
        t_l = device_ms(lambda: library(nxt(), dtype))
        b_gn = bound(2 * B * C * H * W * 2 + 2 * C * 4, 12 * B * C * H * W,
                     torch.float32)
        print(f"  gn  bf16 x={[B, C, H, W]}: path {plan.path} (cluster "
              f"{plan.cluster}); err {e_gn:.3g}  kernel {t_k:.4f} ms "
              f"silu(group_norm) {t_l:.4f} bound {b_gn[0]:.4f}")
        ratios.append((t_k / t_l, [B, C, H, W]))
        del x, gamma, beta, nxt, y, y_ref
    worst = max(ratios)
    print(f"  gn_swish bf16 at all {len(main)} main-path shapes (B = "
          f"{', '.join(map(str, MAIN_PATH_BATCHES))}): kernel / "
          f"silu(group_norm) {min(ratios)[0]:.2f}-{worst[0]:.2f}, the "
          f"highest at {worst[1]}")
    rec["gn_swish"]["main_path"] = {
        "shapes": len(main), "dtype": "bfloat16",
        "worst_kernel_to_library": worst[0], "worst_shape": worst[1]}

    # near-constant, large-mean bf16 maps: the clamped variance stays finite
    C = 64
    for c in (2285.4912, 1862.8314, 3861.9184):
        x = torch.full((1, C, 32, 32), c, dtype=torch.bfloat16, device=dev)
        y = gn_swish(x, torch.ones(C, device=dev),
                     torch.full((C,), 0.3, device=dev), G).float()
        torch.cuda.synchronize()
        require(torch.isfinite(y).all(), f"gn_swish NaN on constant map {c}")
        require(abs(float(y.mean()) - 0.3 / (1 + math.exp(-0.3))) < 0.05,
                f"constant map {c} does not normalise to swish(beta)")
    print(f"  gn  near-constant large-mean bf16 maps (path "
          f"{gn_plan(1, C, G, 32 * 32, torch.bfloat16).path}): finite, "
          f"~swish(beta)")

    n_hgmma, n_hmma = tensor_core_instructions("attention")
    print(f"  attention library: {n_hgmma} HGMMA, {n_hmma} HMMA instructions "
          f"in its SASS (cuobjdump -sass)")
    require(n_hgmma + n_hmma > 0,
            "the built attention library has no tensor-core instruction")
    # the long path's bf16 products and the fp32 path's 3xTF32 run on the
    # tensor cores: HMMA in each instantiation of the tiled kernel
    hmma = sass_by_function("attention", " HMMA.")
    for inst in ("attn_tiled_kernelI13__nv_bfloat16", "attn_tiled_kernelIf"):
        n = sum(c for f, c in hmma.items() if inst in f)
        print(f"  {inst}...: {n} HMMA instructions")
        require(n > 0, f"{inst}: no tensor-core instruction in its SASS")
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ATTN_SHAPES:
            B, HW, C = shape
            el = 2 if dtype == torch.bfloat16 else 4
            nbytes = 4 * B * HW * C * el

            def make(i, shape=shape, dtype=dtype):
                g = torch.Generator().manual_seed(100 + i)
                return tuple(torch.randn(shape, generator=g).to(dtype)
                             .to(dev) for _ in range(3))

            (q, k, v), nxt = _rotating(make, nbytes)
            plan = attn_plan(HW, C, dtype)
            out = spatial_attention(q, k, v)
            ref = spatial_attention_reference(q, k, v, C ** -0.5)
            torch.cuda.synchronize()
            atol, rtol = ATTN_TOL[dtype]
            e = float((out.float() - ref.float()).abs().max())
            require(torch.allclose(out.float(), ref.float(), atol=atol,
                                   rtol=rtol),
                    f"attention disagrees at {shape} {dtype}: {e}")
            err["spatial_attention"] = max(err["spatial_attention"], e)
            if dtype == torch.float32:
                # the kernel and the plain version may round identically;
                # show the kernel's distance from an fp64 evaluation too
                s64 = torch.einsum("bic,bjc->bij", q.double(), k.double())
                ref64 = torch.softmax(s64 * C ** -0.5, -1) @ v.double()
                e64 = float((out.double() - ref64).abs().max())
                require(e64 < 1e-4, f"attention vs fp64 at {shape}: {e64}")
                print(f"  attn {dtype} {list(shape)}: err vs fp64 {e64:.3g}")
            t_k = device_ms(lambda: spatial_attention(*nxt()))
            t_p = device_ms(
                lambda: spatial_attention_reference(*nxt(), C ** -0.5))
            t_l = device_ms(lambda: (lambda a: F.scaled_dot_product_attention(
                a[0][:, None], a[1][:, None], a[2][:, None],
                scale=C ** -0.5))(nxt()))
            b = bound(nbytes, 4 * B * HW * HW * C, dtype)
            print(f"  attn {dtype} {list(shape)}: path {plan.path} "
                  f"({plan.why}); err {e:.3g} (atol {atol}, rtol {rtol})  "
                  f"kernel {t_k:.4f} ms plain {t_p:.4f} sdpa {t_l:.4f} "
                  f"bound {b[0]:.5f} ({b[1]})")
            top = dtype == torch.bfloat16 and shape == (8, 64, 512)
            _record(rec, "spatial_attention", top, {
                "shape": list(shape), "dtype": _dtype_name(dtype),
                "path": plan.path, "cluster": plan.cluster, "ms": t_k,
                "plain_ms": t_p, "library_ms": t_l, "bound_ms": b[0],
                "bound_by": b[1]})
            # the clusters add their partials in rank order: every path
            require(all(torch.equal(spatial_attention(q, k, v), out)
                        for _ in range(3)),
                    f"attention does not repeat bit for bit at {shape} "
                    f"{dtype}")
            print(f"      repeats bit for bit (3 runs, {plan.path}, "
                  f"clusters of {plan.cluster})")
            del q, k, v, nxt, out, ref
    for name in rec:
        rec[name]["max_abs_err"] = err[name]
    return rec


# a bf16 UNet forward whose attention runs the kernel against the same
# forward with the plain attention: the kernels' outputs differ by bf16
# ulps, which the rest of the network carries (max and mean |difference|
# over the output's largest and mean |value|: 0.0084 / 0.0087 on an H100
# at 700 W).  With random weights attention moves the output little: a
# forward with the last 64 keys of every attention dropped lands only
# 0.0105 / 0.0097 off, so the check that holds the kernels is each call's
# against the plain version on its own inputs, at ATTN_TOL; the control is
# printed
ATTN_UNET_TOL = (0.05, 0.03)


def phase_attention_unet(dev) -> dict:
    """One bf16 forward of a UNet at the flagship widths (inner channel 64,
    multipliers 1, 2, 4, 8, 8, two res blocks) with the module's default
    gate (``image_size=128, attn_res=(16,)``) on 256² inputs at B = 2,
    random weights from seed 0: attention at 32² (1024 tokens, C = 512) on
    the long path, the mid block at 16² (256 tokens).  Held against the
    same forward with ``spatial_attention_reference`` patched in, and each
    attention call against the plain version on its own inputs; both
    forwards timed (host clock after ``torch.cuda.synchronize``, median of
    3).  No repo config has this gate over this input size."""
    import sr3d_torch.models.sr3_unet as unet_mod
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.kernels.attention import (
        attn_plan,
        spatial_attention_reference,
    )

    torch.manual_seed(0)
    unet = unet_mod.SR3UNet(inner_channel=64, channel_mults=(1, 2, 4, 8, 8),
                            res_blocks=2, attn_res=(16,), image_size=128,
                            dtype=torch.bfloat16).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 6, 256, 256, generator=g, device=dev)
    t = torch.rand(2, 1, generator=g, device=dev)
    kernel = unet_mod.spatial_attention
    paths: list = []
    errs: list = []   # each call's kernel output against the plain version

    def counted(q, k, v, channels=None):
        paths.append((tuple(q.shape),
                      attn_plan(q.shape[1], q.shape[2], q.dtype).path))
        out = kernel(q, k, v, channels)
        if len(errs) < 6:
            ref = spatial_attention_reference(
                q, k, v, 1.0 / math.sqrt(channels or q.shape[-1]))
            errs.append(float((out.float() - ref.float()).abs().max()))
            require(torch.allclose(out.float(), ref.float(),
                                   atol=ATTN_TOL[q.dtype][0],
                                   rtol=ATTN_TOL[q.dtype][1]),
                    f"attention in the 256² forward at {tuple(q.shape)}: "
                    f"{errs[-1]}")
        return out

    def plain(q, k, v, channels=None):
        return spatial_attention_reference(
            q, k, v, 1.0 / math.sqrt(channels or q.shape[-1]))

    def dropped(q, k, v, channels=None):  # the control: a key tile lost
        return plain(q, k[:, :-64], v[:, :-64], channels)

    def forward(fn):
        unet_mod.spatial_attention = fn
        try:
            with torch.no_grad():
                out = unet(x, t)
        finally:
            unet_mod.spatial_attention = kernel
        torch.cuda.synchronize()
        return out

    reset_launch_counts()
    out = forward(counted)
    launches = launch_counts()["spatial_attention"]
    first = list(paths)
    n_long = sum(p == "long" for _, p in first)
    require(n_long == 5 and launches == len(first) == 6,
            f"the 256² forward: {launches} attention launches, paths "
            f"{first} (want 5 long at 1024 tokens and the mid block)")
    ref = forward(plain)

    def gap(a):
        d = (a.float() - ref.float()).abs()
        return (float(d.max() / ref.float().abs().max()),
                float(d.mean() / ref.float().abs().mean()))

    rel, ctrl = gap(out), gap(forward(dropped))
    require(bool(torch.isfinite(out).all()) and out.shape == x[:, :3].shape
            and rel[0] < ATTN_UNET_TOL[0] and rel[1] < ATTN_UNET_TOL[1],
            f"the 256² forward with the kernels disagrees with the plain "
            f"attention's: max / mean |difference| {rel} (limits "
            f"{ATTN_UNET_TOL})")
    long_shapes = sorted({s for s, p in first if p == "long"})
    mid = [p for s, p in first if p != "long"]

    def timed(fn):
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward(fn)
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[1]

    t_k, t_p = timed(counted), timed(plain)
    print(f"  UNet 256² bf16 B = 2, default gate (image_size 128, attn_res "
          f"16): {launches} attention launches ({n_long} long at "
          f"{long_shapes}, the mid block {mid}), each within ATTN_TOL of "
          f"the plain version on its own inputs (max err {max(errs):.3g}); "
          f"the whole forward against the plain "
          f"attention max / mean |difference| {rel[0]:.3g} / {rel[1]:.3g} "
          f"of the output's max / mean |value| (limits {ATTN_UNET_TOL}; "
          f"the control with 64 keys dropped {ctrl[0]:.3g} / "
          f"{ctrl[1]:.3g}); forward {t_k:.1f} ms, with the plain attention "
          f"{t_p:.1f} ms")
    del unet, x, t, out, ref
    return {"long_path_unet": {
        "shape": [2, 6, 256, 256], "dtype": "bfloat16",
        "attention_launches": launches, "long_launches": n_long,
        "max_rel_diff": rel[0], "mean_rel_diff": rel[1],
        "control_rel_diff": list(ctrl), "max_abs_err": max(errs),
        "forward_ms": t_k, "plain_attention_forward_ms": t_p}}


def sass_count(stem: str, op: str) -> int:
    """Instructions whose text holds ``op`` in the SASS of the library
    built from ``csrc/<stem>.cu``."""
    return sum(sass_by_function(stem, op).values())


def sass_by_function(stem: str, op: str) -> dict[str, int]:
    """Instructions whose text holds ``op`` in each kernel function of the
    SASS of the library built from ``csrc/<stem>.cu``, by mangled name."""
    from sr3d_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(_build._target(_build.CSRC / f"{stem}.cu"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and op in ln.split(";")[0]:
            counts[name] += 1
    return counts


def tensor_core_instructions(stem: str) -> tuple[int, int]:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of the
    library built from ``csrc/<stem>.cu``."""
    return sass_count(stem, " HGMMA."), sass_count(stem, " HMMA.")


def main_path_int8_convs() -> list[tuple]:
    """(B, Cin, H, W, O, stride, scale) of every int8 conv of one forward
    of the flagship UNet as the serving CLI runs it (quant_min_res 1,
    resampling on), at B = 8, in order: a meta-device trace (no memory, no
    arithmetic).  ``scale`` is "static" (a ConvBlock: its GN affine) or
    "dynamic" (a Downsample or Upsample)."""
    import sr3d_torch.models.sr3_unet as unet_mod
    import sr3d_torch.ops.quant as quant_mod

    cfg = serving_cfg("ddim")
    cfg.sr.model.unet.quant_min_res = 1
    cfg.sr.model.unet.quant_resample = True
    calls: list = []

    def record(x, wk, w_scale, bias=None, *, stride=1, padding=1,
               out_dtype=None, a_scale=None):
        B, C, H, W = x.shape
        calls.append((B, C, H, W, wk.shape[0], stride,
                      "dynamic" if a_scale is None else "static"))
        return x.new_empty(B, wk.shape[0], (H - 1) // stride + 1,
                           (W - 1) // stride + 1)

    saved = (unet_mod.gn_swish, unet_mod.spatial_attention,
             quant_mod.int8_conv_quantized)
    unet_mod.gn_swish = lambda x, *a, **k: x
    unet_mod.spatial_attention = lambda q, k, v, channels=None: q
    quant_mod.int8_conv_quantized = record
    try:
        with torch.device("meta"), torch.no_grad():
            unet = unet_mod.unet_from_config(cfg.sr.model.unet,
                                             cfg.sr.model.diffusion)
            unet(torch.zeros(8, int(cfg.sr.model.unet.in_channel), 128,
                             128), torch.zeros(8, 1), quant=True)
    finally:
        (unet_mod.gn_swish, unet_mod.spatial_attention,
         quant_mod.int8_conv_quantized) = saved
    return calls


# the int8 conv's first-version path (int8_plan's "mma"): ragged channel
# counts, a W whose rows are no multiple of 16 bytes on images of more than
# 128 output pixels, fp32 in; (B, Cin, H, W, O, stride, scale, dtype)
INT8_FIRST_VERSION = ((8, 40, 64, 64, 24, 1, "static", torch.bfloat16),
                      (2, 32, 16, 16, 32, 2, "dynamic", torch.bfloat16),
                      (1, 64, 12, 13, 64, 1, "static", torch.bfloat16),
                      (4, 96, 32, 32, 48, 1, "dynamic", torch.float32))
# its short-row path (int8_plan's "deep"): the 8->32 UNet's convs at the 4²
# and 2² levels (B = 8), an odd W
INT8_SHORT_ROW = ((8, 512, 2, 2, 512, 1, "static", torch.bfloat16),
                  (8, 1024, 2, 2, 512, 1, "static", torch.bfloat16),
                  (8, 256, 4, 4, 512, 1, "static", torch.bfloat16),
                  (8, 512, 4, 4, 512, 1, "static", torch.bfloat16),
                  (8, 512, 4, 4, 512, 1, "dynamic", torch.bfloat16),
                  (8, 512, 4, 4, 512, 2, "dynamic", torch.bfloat16),
                  (8, 1024, 4, 4, 512, 1, "static", torch.bfloat16),
                  (8, 768, 4, 4, 512, 1, "static", torch.bfloat16),
                  (1, 64, 9, 13, 64, 1, "static", torch.bfloat16))


def phase_int8_conv(dev) -> dict:
    """The int8 conv kernels against their plain version, bit for bit, at
    every distinct int8 conv of the serving CLI's UNet forward (bf16 in
    and out, B = 8; int8_plan's tensor-core path), at fp32 in and every
    (stride, scale) pair, at shapes on the first-version path and at the
    8->32 UNet's short-row convs (the short-row path); each shape's plan
    printed.  Each shape timed on the cached path (weights
    quantized and packed beforehand, as ``Int8Conv`` keeps them: one
    launch) and cold (``int8_conv``, the weights quantized first), against
    its plain version, the library route (im2col + ``torch._int_mm`` on the
    same quantized weights) and cuDNN's bf16 conv; IGMMA (s8 wgmma) and
    IMMA (mma.sync s8) required in the built library.  Returns the
    kernel's record."""
    import torch.nn.functional as F

    from sr3d_torch.kernels import int8_conv
    from sr3d_torch.kernels.int8_conv import (
        dynamic_scale,
        int8_conv_quantized,
        int8_conv_reference,
        int8_plan,
        prepare_weight,
        quantize_weight,
    )

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    n_igmma, n_imma = (sass_count("int8_conv", op)
                       for op in (" IGMMA.", " IMMA."))
    print(f"  int8_conv library: {n_igmma} IGMMA (s8 wgmma) and {n_imma} "
          f"IMMA (mma.sync s8) instructions in its SASS (cuobjdump -sass)")
    require(n_igmma > 0, "the built int8 conv library has no IGMMA "
                         "instruction")
    require(n_imma > 0, "the built int8 conv library has no IMMA "
                        "instruction")
    calls = main_path_int8_convs()
    require(len(calls) == 58, f"{len(calls)} int8 convs a forward, want 58")
    shapes = sorted(set(calls), key=lambda c: -c[1] * c[2] * c[3])
    print(f"  int8_conv: {len(calls)} convs a UNet forward at the CLI's "
          f"default (quant_min_res 1, resampling), {len(shapes)} distinct")
    extra = [(8, 64, 128, 128, 64, st, sc, torch.float32)
             for st in (1, 2) for sc in ("static", "dynamic")]
    cases = ([c + (torch.bfloat16, "wgmma") for c in shapes]
             + [c + ("wgmma",) for c in extra]
             + [c + ("mma",) for c in INT8_FIRST_VERSION]
             + [c + ("deep",) for c in INT8_SHORT_ROW])

    def library(x, wq, ws, b, stride, a):
        """im2col + torch._int_mm: the library's int8 route, on weights
        quantized beforehand."""
        B, C, H, W = x.shape
        xq = torch.round(x.float() / a).clamp_(-127, 127)
        cols = F.unfold(xq.to(torch.bfloat16), 3, padding=1, stride=stride)
        L = cols.shape[-1]
        cols = cols.transpose(1, 2).reshape(B * L, -1).to(torch.int8)
        y = torch._int_mm(cols, wq.reshape(wq.shape[0], -1).t())
        out = y.float() * (a * ws) + b
        Ho = (H - 1) // stride + 1
        return out.reshape(B, L, -1).transpose(1, 2).reshape(
            B, -1, Ho, L // Ho).to(torch.bfloat16)

    rec: dict = {}
    for (B, C, H, W, O, stride, scale, dtype, path) in cases:
        el = 2 if dtype == torch.bfloat16 else 4
        plan = int8_plan(B, C, H, W, O, stride, sm_count, in_dtype=dtype)
        require(plan.path == path, f"int8_plan takes {plan.path} at "
                f"{(B, C, H, W)}->{O} stride {stride} {dtype}, want {path}: "
                f"{plan.why}")

        def make(i, B=B, C=C, H=H, W=W, O=O, dtype=dtype):
            g = torch.Generator(device=dev).manual_seed(400 + i)
            w = (torch.randn(O, C, 3, 3, generator=g, device=dev)
                 * (9 * C) ** -0.5)
            return ((torch.randn(B, C, H, W, generator=g, device=dev) * 2)
                    .to(dtype), w,
                    torch.randn(O, generator=g, device=dev) * 0.1,
                    torch.tensor(0.05, device=dev), *prepare_weight(w),
                    quantize_weight(w)[0])

        a0, nxt = _rotating(make, B * C * H * W * el)
        st = scale == "static"
        kw = dict(stride=stride, out_dtype=dtype)
        call = lambda a: int8_conv_quantized(a[0], a[4], a[5], a[2],
                                             a_scale=a[3] if st else None,
                                             **kw)
        cold = lambda a: int8_conv(a[0], a[1], a[2], a_scale=a[3] if st
                                   else None, **kw)
        call_plain = lambda a: int8_conv_reference(
            a[0], a[1], a[2], a_scale=a[3] if st else None, **kw)
        out, out_cold, ref = call(a0), cold(a0), call_plain(a0)
        torch.cuda.synchronize()
        e = float((out.float() - ref.float()).abs().max())
        require(torch.equal(out, ref) and torch.equal(out_cold, ref),
                f"int8_conv differs from its plain version at "
                f"{(B, C, H, W)}->{O} stride {stride} {scale} {dtype} "
                f"({path}): max {e}")
        require(torch.equal(call(a0), out), f"int8_conv repeats differ at "
                f"{(B, C, H, W)}->{O} stride {stride} ({path})")
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        ops = 2 * B * Ho * Wo * O * 9 * C
        io = (B * C * H * W + B * O * Ho * Wo) * el
        # the cached call reads the int8 weights, their steps and the
        # bias; the cold call the fp32 weights and the bias
        bd = bound(io + 9 * C * O + 2 * O * 4, ops, torch.int8)
        bd_cold = bound(io + (9 * C + 2) * O * 4, ops, torch.int8)
        t_k = device_ms(lambda: call(nxt()), reps=5)
        t_cold = device_ms(lambda: cold(nxt()), reps=5)
        t_p = device_ms(lambda: call_plain(nxt()), reps=2)
        row = {"shape": [B, C, H, W, O], "stride": stride, "scale": scale,
               "dtype": _dtype_name(dtype), "path": plan.path,
               "splits": plan.splits, "ms": t_k, "plain_ms": t_p,
               "bound_ms": bd[0], "bound_by": bd[1], "cold_ms": t_cold,
               "cold_bound_ms": bd_cold[0], "library_ms": None,
               "cudnn_bf16_ms": None}
        # torch._int_mm takes sizes that are multiples of 8
        if dtype == torch.bfloat16 and (B * Ho * Wo) % 8 == 0 and O % 8 == 0:
            lib = lambda a: library(a[0], a[6], a[5], a[2], stride, a[3]
                                    if st else dynamic_scale(a[0]))
            require(torch.equal(lib(a0), out),
                    f"im2col + _int_mm differs at {(B, C, H, W)}->{O}")
            row["library_ms"] = device_ms(lambda: lib(nxt()), reps=2)
        if dtype == torch.bfloat16:
            row["cudnn_bf16_ms"] = device_ms(lambda: (lambda a: F.conv2d(
                a[0], a[1].to(dtype), a[2].to(dtype), stride, 1))(nxt()),
                reps=5)
        tile = (f"{plan.images}x{plan.rows}x{plan.tile_w} px x {plan.bn}, "
                f"{plan.ctas} CTAs"
                if plan.path != "mma" else "64 x 64")
        print(f"  int8_conv {_dtype_name(dtype)} x={[B, C, H, W]}->{O} "
              f"stride {stride} {scale} scale: {plan.path} ({tile}, "
              f"splits {plan.splits}), bit-equal to plain, cached and cold; "
              f"kernel {t_k:.4f} ms ({ops / t_k / 1e9:.1f} TOP/s) cold "
              f"{t_cold:.4f} plain {t_p:.4f} im2col+_int_mm "
              f"{row['library_ms'] or float('nan'):.4f} cuDNN bf16 conv "
              f"{row['cudnn_bf16_ms'] or float('nan'):.4f} bound "
              f"{bd[0]:.4f} ({bd[1]}; cold {bd_cold[0]:.4f})")
        top = (dtype == torch.bfloat16 and (C, H, O, stride) ==
               (192, 128, 64, 1))
        _record(rec, "int8_conv", top, row)
        if top:
            rec["int8_conv"].update(cudnn_bf16_ms=row["cudnn_bf16_ms"],
                                    cold_ms=t_cold,
                                    cold_bound_ms=bd_cold[0])
        del a0, nxt, out, out_cold, ref
    # a forward's int8 convs: each shape's time times its count
    by_shape = {(*r["shape"][:4], r["shape"][4], r["stride"], r["scale"]): r
                for r in rec["int8_conv"]["shapes"]
                if r["dtype"] == "bfloat16" and r["path"] == "wgmma"}
    fwd = {k: sum(by_shape[c][k] for c in calls)
           for k in ("ms", "cold_ms", "library_ms", "cudnn_bf16_ms",
                     "bound_ms", "cold_bound_ms")}
    print(f"  int8_conv, the {len(calls)} convs of a forward: kernel "
          f"{fwd['ms']:.3f} ms cached, {fwd['cold_ms']:.3f} ms cold; "
          f"im2col+_int_mm {fwd['library_ms']:.3f} ms, cuDNN bf16 conv at "
          f"the same shapes {fwd['cudnn_bf16_ms']:.3f} ms; bound "
          f"{fwd['bound_ms']:.4f} ms ({fwd['cold_bound_ms']:.4f} cold)")
    rec["int8_conv"].update(max_abs_err=0.0, convs_per_forward=len(calls),
                            forward_ms=fwd)
    return rec


def phase_conv_kernels(dev) -> dict:
    """TPU kernels 4 and 5 (public functions that no model path calls, as
    in the JAX package) against their plain versions at the flagship
    UNet's shapes; returns their records (top level: the widest shape,
    bf16; ``shapes``: every shape and dtype)."""
    import torch.nn.functional as F

    from sr3d_torch.kernels import conv3x3, fused_gn_swish_conv3x3, gn_swish
    from sr3d_torch.kernels.conv3x3 import conv3x3_reference, conv_plan
    from sr3d_torch.kernels.fused_block import fused_block_reference

    n_hgmma, n_hmma = tensor_core_instructions("conv3x3")
    print(f"  conv3x3 library: {n_hgmma} HGMMA, {n_hmma} HMMA instructions "
          f"in its SASS (cuobjdump -sass)")
    require(n_hgmma > 0, "the built conv library has no HGMMA instruction")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec: dict = {}
    err = {"conv3x3": 0.0, "fused_gn_swish_conv3x3": 0.0}
    G = 32
    cases = (("fused_gn_swish_conv3x3", (8, 128, 128, 64), 64),
             ("fused_gn_swish_conv3x3", (8, 128, 128, 192), 64),
             ("fused_gn_swish_conv3x3", (8, 8, 8, 1024), 512),
             ("conv3x3", (8, 128, 128, 6), 64),      # conv_in
             ("conv3x3", (8, 128, 128, 128), 128))   # an Upsample conv
    widest = {("fused_gn_swish_conv3x3", 192), ("conv3x3", 128)}
    for dtype in (torch.bfloat16, torch.float32):
        el = 2 if dtype == torch.bfloat16 else 4
        for name, (B, H, W, C), O in cases:
            def make(i, B=B, H=H, W=W, C=C, O=O, dtype=dtype):
                g = torch.Generator().manual_seed(200 + i)
                x = (torch.randn(B, H, W, C, generator=g) * 2 + 0.5) \
                    .to(dtype).to(dev)
                w = (torch.randn(3, 3, C, O, generator=g) * (9 * C) ** -0.5) \
                    .to(dtype).to(dev)
                b = (torch.randn(O, generator=g) * 0.1).to(dev)
                gamma = (torch.rand(C, generator=g) + 0.5).to(dev)
                beta = (torch.randn(C, generator=g) * 0.1).to(dev)
                # the yardsticks' operands: NCHW x and OIHW w as the serving
                # ConvBlock holds them; channels-last OIHW for the conv alone
                return (x, w, b, gamma, beta,
                        x.permute(0, 3, 1, 2).contiguous(),
                        w.permute(3, 2, 0, 1).contiguous(),
                        w.permute(3, 0, 1, 2).contiguous()
                        .permute(0, 3, 1, 2))

            a0, nxt = _rotating(make, B * H * W * C * el)
            if name == "conv3x3":
                call = lambda a: conv3x3(a[0], a[1], a[2])
                call_plain = lambda a: conv3x3_reference(a[0], a[1], a[2])
                call_lib = lambda a: F.conv2d(a[0].permute(0, 3, 1, 2), a[7],
                                              a[2].to(dtype), padding=1)
                lib_name = "F.conv2d (cuDNN, channels-last)"
                extra = 0
            else:
                call = lambda a: fused_gn_swish_conv3x3(a[0], a[3], a[4],
                                                        a[1], a[2], G)
                call_plain = lambda a: fused_block_reference(
                    a[0], a[3], a[4], a[1], a[2], G)
                call_lib = lambda a: F.conv2d(
                    gn_swish(a[5], a[3], a[4], G), a[6], a[2].to(dtype),
                    padding=1)
                lib_name = "F.conv2d(gn_swish(x)), the serving ConvBlock"
                extra = 2 * C * 4
            out, ref = call(a0), call_plain(a0)
            torch.cuda.synchronize()
            atol, rtol = CONV_TOL[dtype]
            e = float((out.float() - ref.float()).abs().max())
            require(torch.allclose(out.float(), ref.float(), atol=atol,
                                   rtol=rtol),
                    f"{name} disagrees at {(B, H, W, C)}->{O} {dtype}: {e}")
            err[name] = max(err[name], e)
            t_k, t_p, t_l = (device_ms(lambda f=f: f(nxt()), reps=5)
                             for f in (call, call_plain, call_lib))
            ops = 2 * B * H * W * C * O * 9
            nbytes = (B * H * W * (C + O) + 9 * C * O) * el + 4 * O + extra
            bd = bound(nbytes, ops, dtype)
            plan = conv_plan(B, H, W, C, O, dtype, sms)
            print(f"  {name} {dtype} x={[B, H, W, C]}->{O}: err {e:.3g} "
                  f"(atol {atol}, rtol {rtol})  kernel {t_k:.4f} ms "
                  f"({ops / t_k / 1e9:.1f} TF/s) plain {t_p:.4f} {lib_name} "
                  f"{t_l:.4f} bound {bd[0]:.4f} ({bd[1]})")
            print(f"      path {plan.path}, splits {plan.splits} "
                  f"({plan.why})")
            if plan.splits > 1:   # fixed-order sums: the same bits again
                require(all(torch.equal(call(a0), out) for _ in range(3)),
                        f"{name} split K does not repeat at {(B, H, W, C)}")
                print("      split-K output repeats bit for bit (3 runs)")
            top = dtype == torch.bfloat16 and (name, C) in widest
            _record(rec, name, top,
                    {"shape": [B, H, W, C, O], "dtype": _dtype_name(dtype),
                     "path": plan.path, "splits": plan.splits, "ms": t_k,
                     "plain_ms": t_p, "library_ms": t_l, "bound_ms": bd[0],
                     "bound_by": bd[1]})
            del a0, nxt, out, ref
    for name in rec:
        rec[name]["max_abs_err"] = err[name]
    return rec


def phase_gradients(dev) -> None:
    """GN+Swish and attention through their autograd Functions (kernels
    forward) against autograd of their plain versions, on the card."""
    from sr3d_torch.kernels import (
        gn_swish,
        launch_counts,
        reset_launch_counts,
        spatial_attention,
    )
    from sr3d_torch.kernels.attention import spatial_attention_reference
    from sr3d_torch.kernels.groupnorm_swish import gn_swish_reference

    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator().manual_seed(300)
        x = (torch.randn(4, 64, 128, 128, generator=g) * 2 + 0.5).to(dtype)
        gy = torch.randn(x.shape, generator=g).to(dtype)
        gamma, beta = torch.rand(64, generator=g) + 0.5, \
            torch.randn(64, generator=g) * 0.1
        q, k, v, go = (torch.randn(4, 64, 512, generator=g).to(dtype)
                       for _ in range(4))
        cases = (("gn_swish", (x, gamma, beta), gy,
                  lambda *a: gn_swish(*a, 32),
                  lambda *a: gn_swish_reference(*a, 32)),
                 ("spatial_attention", (q, k, v), go, spatial_attention,
                  lambda *a: spatial_attention_reference(*a, 512 ** -0.5)))
        atol, rtol = GN_TOL[dtype]
        for name, ins, gout, kern, ref in cases:
            grads = []
            for fn in (kern, ref):
                t = [a.to(dev).requires_grad_() for a in ins]
                out = fn(*t)
                require(out.grad_fn is not None, f"{name}: no grad_fn")
                reset_launch_counts()
                grads.append(torch.autograd.grad(out, t, gout.to(dev)))
                if fn is kern and name == "gn_swish":
                    require(launch_counts()["gn_swish_backward"] == 1,
                            f"the GN+Swish gradient did not go through "
                            f"gn_swish_backward: {launch_counts()}")
            torch.cuda.synchronize()
            e = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(*grads))
            # GN's dγ and dβ: sums of B·H·W terms (GN_BWD_SUM_TOL)
            tols = [(atol, rtol)] * 3 if name != "gn_swish" else [
                (atol, rtol)] + [(GN_BWD_SUM_TOL[0] * float(b.abs().max()),
                                  GN_BWD_SUM_TOL[1]) for b in grads[1][1:]]
            require(all(torch.allclose(a.float(), b.float(), atol=t[0],
                                       rtol=t[1])
                        for a, b, t in zip(*grads, tols)),
                    f"{name} gradient disagrees {dtype}: {e}")
            print(f"  grad {name} {dtype}: max abs err {e:.3g} vs autograd "
                  f"of the plain version (atol {atol}, rtol {rtol})"
                  + ("; dgamma, dbeta within GN_BWD_SUM_TOL of their "
                     "scale; backward: the gn_swish_backward kernel"
                     if name == "gn_swish" else ""))


def _leaf_ok(got: torch.Tensor, ref: torch.Tensor, rel: float) -> bool:
    """``got`` within ``rel`` of ``ref``'s largest entry (floor 1e-6); at
    most 1% of the elements beyond that (a PReLU input or an L1 difference
    at 0 flips one element's slope), none by more than a tenth."""
    scale = float(ref.abs().max())
    e = (got - ref).abs()
    return (float((e > rel * scale + 1e-6).float().mean()) <= 0.01
            and float(e.max()) <= 0.1 * scale + 1e-6)


def _net_max(grads: dict) -> dict:
    """Each network's largest gradient entry, over ``"net.leaf"`` keys."""
    out: dict = {}
    for n, g_ in grads.items():
        net = n.split(".")[0]
        out[net] = max(out.get(net, 0.0), float(g_.abs().max()))
    return out


def _tiny_train_step(cfg, d, batch, draws, **replace) -> tuple:
    """One train step of the tiny config on device ``d`` from the weights
    of seed 3: (losses, gradients, parameters after, lrs, launches)."""
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.train.joint import (
        build_joint,
        init_train_state,
        make_train_step,
    )

    mods = dataclasses.replace(build_joint(cfg, device=d, init_seed=3),
                               **replace)
    state = init_train_state(mods, cfg)
    reset_launch_counts()
    state, met = make_train_step(cfg.sr.train.ema_scheduler)(
        mods, state, batch, draws=draws)
    counts = launch_counts()
    nets = {"sr": mods.unet, "arcface": mods.arcface, "mapping": mods.mapping}
    return ({k: float(v) for k, v in met.items()},
            {f"{p}.{n}": t.grad.cpu() for p, net in nets.items()
             for n, t in net.named_parameters() if t.grad is not None},
            {f"{p}.{n}": t.detach().cpu() for p, net in nets.items()
             for n, t in net.named_parameters()},
            {g_["name"]: g_["lr"] for g_ in state.opt.param_groups}, counts)


def phase_tiny_train(dev) -> None:
    """One whole train step on a tiny config (fp32, remat on, dropout 0,
    N = 4, DDIM-4 hand-off), model2 and model3 flow-through: on the GPU
    through the kernels against the CPU through the plain versions, same
    weights and draws; then model3's gradients on the GPU with the
    hand-off's per-step checkpoints on and off."""
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.data.synthetic import synthetic_face_batch
    from sr3d_torch.diffusion.gaussian import sample_continuous_gamma
    from sr3d_torch.diffusion.schedules import schedule_from_config
    from sr3d_torch.ops.image import degrade_pair

    cfg = update_cfg(get_cfg_defaults(), str(TINY))
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.train_remat = True
    cfg.tpu.sample_remat = True
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.mica.train.use_mask = True
    cfg.sr.model.diffusion.train_sampler = "ddim"
    cfg.sr.model.diffusion.train_ddim_steps = 4
    g = torch.Generator().manual_seed(1)
    hr = torch.from_numpy(synthetic_face_batch(4, 16, seed=1))
    batch = {"HR": hr, "SR": degrade_pair(hr, 8, 16)[1],
             "flame_shape": torch.randn(4, 16, generator=g) * 0.3}
    _, gamma = sample_continuous_gamma(
        schedule_from_config(cfg.sr.model.beta_schedule.train), 4,
        generator=g)
    draws = {"gamma": gamma, "noise": torch.randn(4, 3, 16, 16, generator=g),
             "handoff": [torch.randn(4, 3, 16, 16, generator=g)
                         for _ in range(5)]}
    # the tiny UNet: 8 checkpointed blocks (16 GN, 4 attention) + the final
    # GN per forward.  model2: 4 hand-off forwards, the loss forward and the
    # blocks' recompute in the backward; model3 also recomputes each of the
    # 4 checkpointed hand-off steps once
    # each GN+Swish on the loss's tape has one backward: the loss forward's
    # 17, and model3's 4 hand-off steps' 17 each
    want = {"model2": {"gn_swish": 4 * 17 + 17 + 16,
                       "spatial_attention": 4 * 4 + 4 + 4,
                       "gn_swish_backward": 17},
            "model3": {"gn_swish": 2 * 4 * 17 + 17 + 16,
                       "spatial_attention": 2 * 4 * 4 + 4 + 4,
                       "gn_swish_backward": (1 + 4) * 17}}
    for variant in ("model2", "model3"):
        cfg.model = variant
        (m_c, g_c, p_c, lrs, _), (m_g, g_g, p_g, _, counts) = (
            _tiny_train_step(cfg, d, batch, draws) for d in ("cpu", dev))
        # l_sr: fp32 sums in other orders; model2's l_mica follows the
        # uint8 hand-off, where a value on a rounding tie may land one level
        # apart; model3's hand-off is continuous
        tol_mica = 1e-3 if variant == "model2" else 1e-4
        require(abs(m_g["l_sr"] - m_c["l_sr"]) <= 1e-5 * abs(m_c["l_sr"]),
                f"tiny {variant} step l_sr {m_g['l_sr']} vs {m_c['l_sr']}")
        require(abs(m_g["l_mica"] - m_c["l_mica"])
                <= tol_mica * abs(m_c["l_mica"]),
                f"tiny {variant} step l_mica {m_g['l_mica']} vs "
                f"{m_c['l_mica']}")
        require(g_c.keys() == g_g.keys(), f"tiny {variant} gradient leaves")
        # A leaf whose true gradient is 0 (a bias ahead of a batch-statistics
        # BatchNorm, e.g. ArcFace's fc.bias before "features") holds rounding
        # noise only: ~1e-7 on the CPU against leaves of ~1, and on the card
        # noise near _leaf_ok's 1e-6 floor.  Such a leaf (below 1e-5 of its
        # network's largest) is held to that rounding level on the card too.
        net_max = _net_max(g_c)
        zero = {n for n, g_ in g_c.items()
                if float(g_.abs().max()) < 1e-5 * net_max[n.split(".")[0]]}
        # model2's MICA gradients follow the uint8 image (5e-2); model3's
        # MICA leaves next to ArcFace's batch-statistics BatchNorms hold
        # rounding noise as in model2 (5e-2: on the CPU, 1 thread against 8
        # moves them by 2e-3).  model3's UNet gradients carry l_mica's back
        # through ArcFace and the sampling chain, where fp32 rounding grows
        # (the CPU against itself moves small leaves by 1e-3 of their own
        # largest entry): each leaf within 1e-3 of the UNet's largest
        # entry, as tests/test_torch_model3_step.py holds it to JAX
        rel = {"sr": 1e-4, "arcface": 5e-2, "mapping": 5e-2}

        def leaf_ok(n: str) -> bool:
            net = n.split(".")[0]
            if n in zero:
                return float(g_g[n].abs().max()) <= 1e-5 * net_max[net]
            if variant == "model3" and net == "sr":
                return (float((g_g[n] - g_c[n]).abs().max())
                        <= 1e-3 * net_max[net])
            return _leaf_ok(g_g[n], g_c[n], rel[net])

        bad = [n for n in g_c if not leaf_ok(n)]
        worst = {net: max(float((g_g[n] - g_c[n]).abs().max())
                          / (float(g_c[n].abs().max()) + 1e-12)
                          for n in g_c if n.startswith(net + ".")
                          and n not in zero) for net in rel}
        require(not bad, f"tiny {variant} step gradients disagree: "
                         f"{bad[:5]}; worst relative to each leaf's max "
                         f"{worst}")
        off = 0
        for n, p in p_c.items():
            d_ = (p_g[n] - p).abs()
            require(float(d_.max()) <= 2 * lrs[n.split(".")[0]] + 1e-6,
                    f"tiny {variant} parameter {n} off by {float(d_.max())}")
            off += int((d_ > 1e-6).sum())
        total = sum(p.numel() for p in p_c.values())
        require(off <= 0.01 * total, f"tiny {variant}: {off} parameters "
                                     f"apart")
        want_v = dict(want[variant], gn_stats=0, conv3x3=0,
                      fused_gn_swish_conv3x3=0, int8_conv=0)
        require(counts == want_v,
                f"tiny {variant} launches {counts}, want {want_v}")
        unet_err = max(float((g_g[n] - g_c[n]).abs().max()) for n in g_c
                       if n.startswith("sr.")) / net_max["sr"]
        bounds = (rel if variant == "model2" else
                  dict(rel, sr="1e-3 of the UNet's largest entry"))
        print(f"  tiny {variant} train step, GPU kernels vs CPU plain (fp32, "
              f"remat, N=4): l_sr {m_g['l_sr']:.6f} vs {m_c['l_sr']:.6f}, "
              f"l_mica {m_g['l_mica']:.5f} vs {m_c['l_mica']:.5f}; gradients"
              f" within { {k: f'{v:.2g}' for k, v in worst.items()} } of "
              f"each leaf's max, UNet within {unet_err:.2g} of its largest "
              f"entry (bounds {bounds}), {len(zero)} zero-gradient "
              f"leaves within 1e-5 of their network's largest; {off}/{total} "
              f"parameters apart by >1e-6 after the step; launches {counts}")
    # model3 on the card: the hand-off's per-step checkpoints change where
    # the UNet runs again, not the gradients.  Deterministic algorithms
    # (cuDNN's included), so that the two runs sum in the same order
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        runs = [_tiny_train_step(cfg, dev, batch, draws, sample_remat=r)[1]
                for r in (True, False)]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    require(runs[0].keys() == runs[1].keys(), "sample_remat leaves")
    net_max = _net_max(runs[0])
    # each leaf against its largest entry, a zero-gradient leaf (as above)
    # against 1e-5 of its network's largest
    e = max(float((runs[1][n] - g_).abs().max())
            / max(float(g_.abs().max()), 1e-5 * net_max[n.split(".")[0]])
            for n, g_ in runs[0].items())
    require(e <= 1e-6,
            f"tiny model3 gradients with and without sample_remat: {e}")
    print(f"  tiny model3 step on the GPU, sample_remat on vs off: gradients "
          f"within {e:.2g} of each leaf's max (bound 1e-6)")


def phase_tiny_slice(dev) -> None:
    """The whole serving step on a tiny config (fp32): on the GPU through
    the kernels against the CPU through the plain versions, same weights
    and noise."""
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.train.joint import build_joint, make_val_step

    cfg = update_cfg(get_cfg_defaults(), str(TINY))
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.sampler = "ddim"
    cfg.sr.model.diffusion.ddim_steps = 8
    cfg.sr.model.diffusion.sampler_init = "marginal"
    g = torch.Generator().manual_seed(0)
    cond = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1
    noise = [torch.randn(2, 3, 16, 16, generator=g) for _ in range(9)]
    outs = {}
    reset_launch_counts()
    for d in ("cpu", dev):
        mods = build_joint(cfg, device=d, init_seed=3)
        outs[str(d)] = {k: v.float().cpu() for k, v in make_val_step()(
            mods, {"SR": cond}, noise=noise).items()}
    counts = launch_counts()
    a, b = outs["cpu"], outs[str(dev)]
    errs = {k: float((a[k] - b[k]).abs().max()) for k in a}
    print(f"  tiny serving step, GPU kernels vs CPU plain: max abs err "
          f"{ {k: f'{v:.3g}' for k, v in errs.items()} } (sr, identity, "
          f"verts, lmk68 atol 1e-3; img224 within one uint8 level)")
    # the tiny UNet: 8 ResnetBlocks x 2 GN + the final block = 17 GN+Swish
    # and 4 attention blocks per forward; 8 DDIM steps
    require(counts == {"gn_stats": 0, "gn_swish": 8 * 17,
                       "gn_swish_backward": 0, "spatial_attention": 8 * 4,
                       "conv3x3": 0, "fused_gn_swish_conv3x3": 0,
                       "int8_conv": 0},
            f"tiny-step launches {counts}")
    for k in ("sr", "identity", "verts", "lmk68"):
        require(errs[k] < 1e-3, f"tiny step {k} off by {errs[k]}")
    require(errs["img224"] <= 1.0 / 255 + 1e-6,
            f"tiny step img224 off by {errs['img224']}")


def serving_cfg(sampler: str):
    from sr3d_torch.config import get_cfg_defaults, update_cfg

    cfg = update_cfg(get_cfg_defaults(), str(CONFIG))
    d = cfg.sr.model.diffusion
    d.sampler = sampler
    d.ddim_steps, d.ddim_eta, d.sampler_init = 25, 1.0, "marginal"
    cfg.sr.model.unet.quant_min_res = 0
    cfg.tpu.compute_dtype = "bfloat16"
    return cfg


def check_outputs(out: dict, n: int, n_vertices: int, n_shape: int) -> None:
    want = {"sr_u8": ((n, 128, 128, 3), np.uint8),
            "verts": ((n, n_vertices, 3), np.float32),
            "lmk68": ((n, 68, 3), np.float32),
            "identity": ((n, n_shape), np.float32)}
    for k, (shape, dtype) in want.items():
        require(out[k].shape == shape and out[k].dtype == dtype,
                f"{k}: {out[k].shape} {out[k].dtype}, want {shape} {dtype}")
        require(np.isfinite(out[k]).all(), f"{k} not finite")


def serve(p, lr) -> tuple[dict, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = p.predict(lr)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_setup(config: Path):
    """A flagship config in bf16 with the DDIM-25 hand-off, and its train
    batch: N = K×B synthetic faces (seed 0), their bicubic conditioning,
    random FLAME shapes."""
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.data.synthetic import synthetic_face_batch
    from sr3d_torch.ops.image import degrade_pair

    cfg = update_cfg(get_cfg_defaults(), str(config))
    cfg.tpu.compute_dtype = "bfloat16"
    d = cfg.sr.model.diffusion
    d.train_sampler, d.train_ddim_steps = "ddim", 25
    n = int(cfg.mica.datasets.K) * int(cfg.mica.datasets.batch_size)
    lo, hi = (int(cfg.sr.datasets.train.l_resolution),
              int(cfg.sr.datasets.train.r_resolution))
    hr = torch.from_numpy(synthetic_face_batch(n, hi, seed=0))
    g = torch.Generator().manual_seed(0)
    return cfg, {"HR": hr, "SR": degrade_pair(hr, lo, hi)[1],
                 "flame_shape": torch.randn(n, int(cfg.mica.model.n_shape),
                                            generator=g) * 0.3}


def phase_training(dev, flame) -> tuple[dict, dict, float]:
    """The model2 joint train step at the flagship config's full width:
    three steps with the DDIM-25 hand-off, then one with the T=600
    ancestral hand-off.  Returns the kernel launches of the three DDIM
    steps and of the T=600 step, and the mean of DDIM steps 2-3 (s)."""
    from sr3d_torch.diffusion.gaussian import ddim_sample_loop
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.models.arcface import FROZEN_PREFIX_SCOPES
    from sr3d_torch.train.joint import (
        build_joint,
        init_train_state,
        make_train_step,
    )

    cfg, batch = train_setup(CONFIG)
    n = batch["HR"].shape[0]
    lo, hi = (int(cfg.sr.datasets.train.l_resolution),
              int(cfg.sr.datasets.train.r_resolution))
    mods = build_joint(cfg, flame=flame, init_seed=0, device=dev)
    state = init_train_state(mods, cfg)
    step = make_train_step(cfg.sr.train.ema_scheduler)
    gen = torch.Generator(device=dev).manual_seed(0)
    af = mods.arcface
    prefix = {k: v.clone() for k, v in af.state_dict().items()
              if k.split(".")[0] in FROZEN_PREFIX_SCOPES}
    watched = {"sr": mods.unet.conv_in.weight, "sr_mid": mods.unet.mid_0
               .res_block.block2.conv.weight, "arcface": af.fc.weight,
               "mapping": mods.mapping.output.weight}
    before = {k: v.detach().clone() for k, v in watched.items()}
    stats_before = af.bn2.mean.clone()
    n_unet = sum(p.numel() for p in mods.unet.parameters()) / 1e6
    print(f"[6] model2 train step, N={n} faces {lo}->{hi}, unet "
          f"{n_unet:.1f}M params, remat {mods.unet.remat}, "
          f"{mods.unet.dtype} activations")

    def run(sampler: str) -> tuple[float, float, dict]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, met = step(dataclasses.replace(mods, train_sampler=sampler),
                      state, batch, generator=gen)
        m = {k: float(v) for k, v in met.items()}   # waits for the step
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(all(math.isfinite(v) for v in m.values()),
                f"losses not finite: {m}")
        return dt, torch.cuda.max_memory_allocated() / 2 ** 30, m

    plain0 = PLAIN_GN["calls"]
    reset_launch_counts()
    ddim = [run("ddim") for _ in range(3)]
    ddim_counts = launch_counts()
    # the split of a DDIM step: its hand-off sampling alone, timed the same
    # way (the rest is the loss pass, the optimizer and the EMA)
    cond = batch["SR"].to(dev).permute(0, 3, 1, 2).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ddim_sample_loop(mods.unet, mods.sched_train, cond, num_steps=25,
                         eta=1.0, init="marginal", generator=gen)
    torch.cuda.synchronize()
    t_hand = time.perf_counter() - t0
    reset_launch_counts()
    anc = run("ddpm")
    anc_counts = launch_counts()
    T = mods.sched_train.num_timesteps
    for i, (dt, mem, m) in enumerate(ddim + [anc]):
        print(f"    step {i + 1} ({'DDIM-25' if i < 3 else f'T={T}'} "
              f"hand-off): {dt:.3f} s, peak {mem:.2f} GiB, l_sr "
              f"{m['l_sr']:.5f} l_mica {m['l_mica']:.3f}")
    t_step = (ddim[1][0] + ddim[2][0]) / 2
    print(f"    DDIM-25 hand-off alone: {t_hand:.3f} s = "
          f"{100 * t_hand / t_step:.1f}% of the mean of steps 2-3 "
          f"({t_step:.3f} s); loss pass + optimizer + EMA "
          f"{t_step - t_hand:.3f} s")
    for k, v in watched.items():
        require(not torch.equal(v.detach(), before[k]), f"{k} did not move")
    now = af.state_dict()
    require(all(torch.equal(now[k], v) for k, v in prefix.items()),
            "the frozen ArcFace prefix (weights or BN statistics) changed")
    require(not torch.equal(af.bn2.mean, stats_before),
            "ArcFace's head BN statistics did not update")
    require(state.step == 4 and state.ema.step == 4,
            f"step {state.step}, EMA step {state.ema.step}")
    require(all(torch.equal(state.ema.params[k], p.detach())
                for k, p in mods.unet.named_parameters()),
            "EMA is not the warm-up copy of the parameters")
    # 27 checkpointed ResnetBlocWithAttn (54 GN, the mid attention) + the
    # final GN per forward; the hand-off's forwards, the loss forward and
    # the blocks' recompute in the backward; one GN+Swish backward each of
    # the loss forward's 55
    per = {"gn_stats": 0, "gn_swish": 55, "spatial_attention": 1}
    rec_ = {"gn_stats": 0, "gn_swish": 54, "spatial_attention": 1}
    for counts, steps, reps in ((ddim_counts, 25, 3), (anc_counts, T, 1)):
        want = {k: reps * ((steps + 1) * per[k] + rec_[k]) for k in per}
        want.update(conv3x3=0, fused_gn_swish_conv3x3=0, int8_conv=0,
                    gn_swish_backward=reps * 55)
        require(counts == want, f"train launches {counts}, want {want}")
    require_gn_backward(anc_counts, plain0, "phase 6")
    print(f"    params moved (UNet, ArcFace head, mapping); frozen prefix "
          f"and its BN statistics unchanged; EMA step {state.ema.step} "
          f"(warm-up copy below step_start_ema "
          f"{cfg.sr.train.ema_scheduler.step_start_ema})")
    print(f"    launches, 3 DDIM steps: {ddim_counts}; T={T} step: "
          f"{anc_counts} (GN+Swish, one launch each: (hand-off + loss) x 55 "
          f"+ 54 recompute; its backward 55 a step, the kernel; GN+Swish's "
          f"plain version never on the card)")
    print(f"    {smi_line()}")
    return ddim_counts, anc_counts, t_step


def phase_model3(dev, flame) -> dict:
    """The model3 joint train step at the full width of
    ``configs/sr_sr3_VGGF2_16_128_model3.yml``: (a) three flow-through
    steps with the DDIM-25 hand-off; the hand-off's forward and backward
    alone; (c) one flow-through step with the config's T=600 ancestral
    hand-off; (b) one severed step from (a)'s first state and draws.
    Returns the kernel launches of the three (a) steps."""
    from sr3d_torch.diffusion.gaussian import (
        ddim_sample_loop,
        sample_continuous_gamma,
    )
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.models.arcface import FROZEN_PREFIX_SCOPES
    from sr3d_torch.train.joint import (
        build_joint,
        frozen_prefix_mask,
        init_train_state,
        make_train_step,
    )

    cfg, batch = train_setup(MODEL3)
    n, hi = batch["HR"].shape[0], batch["HR"].shape[1]
    mods = build_joint(cfg, flame=flame, init_seed=0, device=dev)
    require(mods.variant == "model3" and mods.sample_remat
            and not mods.sever_sr_grad, "the model3 config's hand-off")
    nets = {"sr": mods.unet, "arcface": mods.arcface,
            "mapping": mods.mapping}
    # snapshots on the host, so that max_memory_allocated is the steps'
    start = {k: {n_: v.to("cpu", copy=True)
                 for n_, v in net.state_dict().items()}
             for k, net in nets.items()}
    state = init_train_state(mods, cfg)
    step = make_train_step(cfg.sr.train.ema_scheduler)
    gen = torch.Generator(device=dev).manual_seed(0)
    T = mods.sched_train.num_timesteps
    shape = (n, 3, hi, hi)
    _, gamma = sample_continuous_gamma(mods.sched_train, n, generator=gen,
                                       device=dev)
    draws1 = {"gamma": gamma,
              "noise": torch.randn(shape, generator=gen, device=dev),
              "handoff": [torch.randn(shape, generator=gen, device=dev)
                          for _ in range(26)]}
    prefix = {k: v.clone() for k, v in mods.arcface.state_dict().items()
              if k.split(".")[0] in FROZEN_PREFIX_SCOPES}
    trainable = frozen_prefix_mask(mods.arcface)

    def params() -> dict:
        return {k: {n_: p.detach().to("cpu", copy=True)
                    for n_, p in net.named_parameters()
                    if k != "arcface" or trainable[n_]}
                for k, net in nets.items()}

    def run(m, st, draws=None) -> tuple[float, float, dict, dict]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, met = step(m, st, batch, generator=gen, draws=draws)
        out = {k: float(v) for k, v in met.items()}   # waits for the step
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        require(all(math.isfinite(v) for v in out.values()),
                f"model3 losses not finite: {out}")
        now = mods.arcface.state_dict()
        require(all(torch.equal(now[k], v) for k, v in prefix.items()),
                "the frozen ArcFace prefix (weights or BN statistics) moved")
        return dt, torch.cuda.max_memory_allocated() / 2 ** 30, out, counts

    plain0 = PLAIN_GN["calls"]
    n_unet = sum(p.numel() for p in mods.unet.parameters()) / 1e6
    print(f"[7] model3 train step ({MODEL3.name}), N={n} faces, unet "
          f"{n_unet:.1f}M params, flow-through (handoff_grad_scale "
          f"{mods.handoff_grad_scale}), per-step hand-off checkpoints, "
          f"block remat {mods.unet.remat}, {mods.unet.dtype} activations")
    # (a) three flow-through steps, DDIM-25 hand-off
    p0 = params()
    a = [run(mods, state, draws1)]
    p1 = params()
    a += [run(mods, state) for _ in range(2)]
    a_counts = {k: sum(r[3][k] for r in a) for k in a[0][3]}
    # the hand-off alone, as the step runs it: forward on the tape with a
    # checkpoint per step, then the backward of a scalar of the sample
    cond = batch["SR"].to(dev).permute(0, 3, 1, 2).contiguous()
    denoise = functools.partial(mods.unet, remat=False)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = ddim_sample_loop(denoise, mods.sched_train, cond, num_steps=25,
                             eta=1.0, init="marginal", generator=gen,
                             differentiable=True, remat=True)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    final.square().sum().backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0 - t_fwd
    hand_counts = launch_counts()
    state.opt.zero_grad(set_to_none=True)
    del final
    # (c) the reference's recipe: flow-through through the T-step loop
    c = run(dataclasses.replace(mods, train_sampler="ddpm"), state)
    # (b) severed, from (a)'s first state and draws
    for k, net in nets.items():
        net.load_state_dict(start[k])
    sev = dataclasses.replace(mods, sever_sr_grad=True)
    b = run(sev, init_train_state(sev, cfg), draws1)
    pb = params()

    for i, (dt, mem, m, _) in enumerate(a):
        print(f"    (a) step {i + 1} (DDIM-25 hand-off, flow-through): "
              f"{dt:.3f} s, peak {mem:.2f} GiB, l_sr {m['l_sr']:.5f} "
              f"l_mica {m['l_mica']:.3f}")
    print(f"    hand-off alone (DDIM-25, N={n}): forward {t_fwd:.3f} s, "
          f"backward {t_bwd:.3f} s (checkpoint recompute + backward)")
    print(f"    (b) severed step from (a)'s first state and draws: "
          f"{b[0]:.3f} s, peak {b[1]:.2f} GiB, l_sr {b[2]['l_sr']:.5f} "
          f"l_mica {b[2]['l_mica']:.3f}")
    print(f"    (c) T={T} ancestral hand-off, flow-through: {c[0]:.3f} s, "
          f"peak {c[1]:.2f} GiB, l_sr {c[2]['l_sr']:.5f} l_mica "
          f"{c[2]['l_mica']:.3f}")
    # (b) against (a) step 1: the same forward, so the same losses and
    # MICA-branch updates (bf16 activations); the UNet's update differs by
    # l_mica's gradient through the hand-off
    for k in ("l_sr", "l_mica"):
        require(abs(b[2][k] - a[0][2][k]) <= 1e-2 * abs(a[0][2][k]),
                f"severed {k} {b[2][k]} vs flow-through {a[0][2][k]}")
    # Adam's first update is lr·g/(|g| + ε) ≈ lr·sign(g): the two updates
    # differ where the gradients' signs do, so count those elements; a
    # gradient at rounding level may flip (as in the parity tests: 1%)
    apart = {}
    for k in nets:
        d_a = torch.cat([(p1[k][n_] - p0[k][n_]).flatten() for n_ in p0[k]])
        d_b = torch.cat([(pb[k][n_] - p0[k][n_]).flatten() for n_ in p0[k]])
        apart[k] = float(((d_b - d_a).abs() > 1e-6).float().mean())
    require(apart["arcface"] <= 1e-2 and apart["mapping"] <= 1e-2,
            f"severed MICA-branch updates differ from flow-through's: "
            f"{apart}")
    require(apart["sr"] >= 1e-2,
            f"severed UNet update equals flow-through's: {apart['sr']}")
    print(f"    severed vs flow-through step 1: |l_sr diff| "
          f"{abs(b[2]['l_sr'] - a[0][2]['l_sr']):.3g}, |l_mica diff| "
          f"{abs(b[2]['l_mica'] - a[0][2]['l_mica']):.3g}; share of "
          f"elements whose updates differ by >1e-6: UNet {apart['sr']:.3g} "
          f"(must be >= 1e-2), ArcFace {apart['arcface']:.3g}, mapping "
          f"{apart['mapping']:.3g} (bound 1e-2); frozen ArcFace prefix "
          f"unchanged in every step")
    # 27 checkpointed ResnetBlocWithAttn (54 GN, the mid attention) + the
    # final GN per forward.  The loss forward and its blocks' recompute;
    # each hand-off step forward once and, flow-through, recomputed once
    # in the backward
    per = {"gn_swish": 55, "spatial_attention": 1}
    rec_ = {"gn_swish": 54, "spatial_attention": 1}

    # one GN+Swish backward each on the loss's tape: the loss forward's 55
    # and, flow-through, each hand-off step's

    def want(steps: int, recomputed: int, reps: int = 1) -> dict:
        w = {k: reps * ((1 + steps + recomputed) * per[k] + rec_[k])
             for k in per}
        return dict(w, gn_stats=0, conv3x3=0, fused_gn_swish_conv3x3=0,
                    int8_conv=0,
                    gn_swish_backward=reps * (1 + recomputed) * 55)

    for what, got, w in (("(a)", a_counts, want(25, 25, 3)),
                         ("(b)", b[3], want(25, 0)),
                         ("(c)", c[3], want(T, T)),
                         ("hand-off alone", hand_counts,
                          dict(want(25, 25), gn_swish=50 * 55,
                               spatial_attention=50,
                               gn_swish_backward=25 * 55))):
        require(got == w, f"model3 {what} launches {got}, want {w}")
    require_gn_backward(c[3], plain0, "phase 7")
    print(f"    launches: (a) 3 steps {a_counts}; (b) {b[3]}; (c) {c[3]} "
          f"(GN+Swish, one launch each: (1 + 2 x hand-off steps) x 55 + 54 "
          f"flow-through, (1 + steps) x 55 + 54 severed; its backward, the "
          f"kernel, (1 + hand-off steps) x 55 flow-through, 55 severed; "
          f"GN+Swish's plain version never on the card)")
    print(f"    {smi_line()}")
    return a_counts


def write_jax_state_npz(path: Path, tree: dict, ema_sr: dict | None,
                        step: int = 5) -> None:
    """A train state in the JAX package's ``save_state_npz`` layout:
    ``{"meta": {epoch, global_step}, "state": (step, params {arcface,
    mapping, sr}, arcface_stats, opt_state, ema)}``, flattened in
    ``jax.tree_util``'s order, with five stand-in optimizer leaves."""
    from sr3d_torch.train.checkpoint import jax_tree_flatten

    params = {k: tree[k] for k in ("arcface", "mapping", "sr")}
    opt = tuple(np.zeros(4, np.float32) for _ in range(5))
    ema = None if ema_sr is None else (ema_sr, np.int32(step))
    leaves, _ = jax_tree_flatten(
        {"meta": {"global_step": step, "epoch": 1},
         "state": (np.int32(step), params, tree["arcface_stats"], opt, ema)})
    np.savez(path, **{f"leaf_{i}": np.asarray(x)
                      for i, x in enumerate(leaves)})


def phase_checkpoints(dev, flame, tmp: Path, req) -> Path:
    """Trained-checkpoint serving on the card: a train state in the JAX
    layout (the port's random weights of seed 0, the EMA those of seed 1)
    served with ``Predictor.from_config(checkpoint=…)``, without and with
    ``use_ema``, bit for bit as the same weights served through
    ``params=`` / the EMA; a converted-UNet ``.npz`` serves the same SR
    images.  Returns the checkpoint's path."""
    from sr3d_torch.serve import Predictor
    from sr3d_torch.train.checkpoint import jax_tree_flatten
    from sr3d_torch.train.joint import build_joint
    from sr3d_torch.utils.bridge import export_jax_params, load_jax_ema

    cfg = serving_cfg("ddim")
    tree = export_jax_params(build_joint(cfg, flame=flame, init_seed=0,
                                         device=dev))
    ema_sr = export_jax_params(build_joint(cfg, flame=flame, init_seed=1,
                                           device=dev))["sr"]
    ckpt, conv = tmp / "best_model.npz", tmp / "unet_converted.npz"
    t0 = time.perf_counter()
    write_jax_state_npz(ckpt, tree, ema_sr)
    np.savez(conv, **{f"leaf_{i}": x for i, x in
                      enumerate(jax_tree_flatten(tree["sr"])[0])})
    t_write = time.perf_counter() - t0
    mb = ckpt.stat().st_size / 2 ** 20
    print(f"[8] checkpoints: a {mb:.0f} MiB train state in the JAX layout "
          f"and a converted UNet written in {t_write:.1f} s")

    def load(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = Predictor.from_config(cfg, batch_size=8, flame=flame, **kw)
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    def run(p):
        return p.predict(req, generator=torch.Generator().manual_seed(5))

    ref_p, t_params = load(params=tree)
    ref = run(ref_p)
    ema_p = Predictor(cfg, ref_p.modules, 8, use_ema=True,
                      ema=load_jax_ema(ema_sr, 5, dev))
    ref_ema = run(ema_p)
    del ref_p, ema_p
    p, t_ckpt = load(checkpoint=str(ckpt))
    got = run(p)
    p_ema, t_ckpt_ema = load(checkpoint=str(ckpt), use_ema=True)
    got_ema = run(p_ema)
    require(p.ema is None and p_ema.ema is not None
            and p_ema.ema.step == 5, "the checkpoint's EMA")
    del p, p_ema
    p_conv, t_conv = load(checkpoint=str(conv))
    got_conv = run(p_conv)
    require(p_conv.ema is None, "a converted UNet has no EMA")
    del p_conv
    for k in ref:
        require(np.array_equal(got[k], ref[k]), f"checkpoint {k} differs "
                f"from the same weights served through params=")
        require(np.array_equal(got_ema[k], ref_ema[k]),
                f"checkpoint use_ema {k} differs from the EMA served")
    require(np.array_equal(got_conv["sr_u8"], ref["sr_u8"]),
            "the converted UNet's SR images differ")
    require(not np.array_equal(got_ema["sr_u8"], got["sr_u8"]),
            "use_ema served the parameters")
    print(f"    from_config: params= {t_params:.2f} s, checkpoint "
          f"{t_ckpt:.2f} s, checkpoint + use_ema {t_ckpt_ema:.2f} s, "
          f"converted UNet {t_conv:.2f} s (module build + load)")
    print(f"    requests of 8 (DDIM-25): checkpoint = params= and "
          f"checkpoint + use_ema = the EMA served, bit for bit in sr_u8, "
          f"verts, lmk68, identity; the converted UNet's sr_u8 too")
    return ckpt


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def phase_cli(dev, ckpt: Path, tmp: Path) -> tuple[dict, dict]:
    """The serving CLI as users run it: ``python -m sr3d_torch.serve``'s
    ``main`` on the flagship config with the checkpoint, over 11
    synthetic 16² LR PNGs, DDIM-25 at batch 8: at the int8 default (58
    int8 convs a forward) and with ``--int8 0``; every bundle checked, the
    PSNR between the two runs' SR images; then the kernels one UNet
    forward launches in each mode, and int8 and bf16 requests of 8 in
    turns, three each, their medians, with no weight quantized during
    them.  Returns the wrappers' launches of the int8 CLI run and the
    kernels of one forward per mode."""
    from PIL import Image

    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.data.synthetic import synthetic_face_batch
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.ops.image import tensor_to_uint8
    from sr3d_torch.ops.quant import Int8Conv
    from sr3d_torch.profile_train import _kernels
    from sr3d_torch.serve import Predictor, apply_serving_flags, main

    lr_dir = tmp / "lr"
    lr_dir.mkdir()
    faces = tensor_to_uint8(torch.from_numpy(
        synthetic_face_batch(11, 16, seed=2))).to(torch.uint8).numpy()
    names = [f"face_{i:02d}" for i in range(11)]
    for n, f in zip(names, faces):
        Image.fromarray(f).save(lr_dir / f"{n}.png")
    base = ["-c", str(CONFIG), "-ckt", str(ckpt), "--input", str(lr_dir),
            "--sampler", "ddim", "--steps", "25", "--batch", "8"]
    runs = {}
    for mode, extra in (("int8", []), ("bf16", ["--int8", "0"])):
        out = tmp / f"out_{mode}"
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        require(main(base + ["--out", str(out)] + extra) == 0,
                f"the CLI ({mode}) failed")
        torch.cuda.synchronize()
        runs[mode] = (time.perf_counter() - t0, launch_counts())
        for n in names:
            for f in ("mesh.ply", "mesh.obj", "identity.npy", "kpt7.npy",
                      "kpt68.npy", f"{n}_sr.png"):
                require((out / n / f).exists(), f"{mode} bundle {n}/{f}")
            img = np.asarray(Image.open(out / n / f"{n}_sr.png"))
            require(img.shape == (128, 128, 3) and img.dtype == np.uint8,
                    f"{mode} SR image {n}: {img.shape} {img.dtype}")
    chunks = 2   # 11 faces at batch 8
    common = {"gn_stats": 0, "gn_swish": chunks * 55 * 25,
              "gn_swish_backward": 0, "spatial_attention": chunks * 25,
              "conv3x3": 0, "fused_gn_swish_conv3x3": 0}
    for mode, n8 in (("int8", 58), ("bf16", 0)):
        want = dict(common, int8_conv=chunks * n8 * 25)
        require(runs[mode][1] == want,
                f"CLI {mode} launches {runs[mode][1]}, want {want}")
    sr = {m: np.stack([np.asarray(Image.open(tmp / f"out_{m}" / n
                                             / f"{n}_sr.png"))
                       for n in names]) for m in runs}
    psnr = psnr_u8(sr["int8"], sr["bf16"])
    print(f"[9] serving CLI (python -m sr3d_torch.serve, {CONFIG.name}, "
          f"DDIM-25, batch 8, 11 faces in 2 chunks): int8 default "
          f"{runs['int8'][0]:.2f} s, --int8 0 {runs['bf16'][0]:.2f} s "
          f"(each: predictor build + checkpoint load + 2 chunks + export); "
          f"bundles complete; launches int8 {runs['int8'][1]}, "
          f"bf16 {runs['bf16'][1]}")
    print(f"    PSNR int8 vs bf16 SR images: {psnr:.2f} dB (random "
          f"weights: a sanity figure, not a quality claim)")

    cfg = update_cfg(get_cfg_defaults(), str(CONFIG))
    preds = {}
    for mode, q in (("int8", None), ("bf16", 0)):
        c = apply_serving_flags(cfg.clone(), sampler="ddim", steps=25,
                                int8=q)
        preds[mode] = Predictor.from_config(c, checkpoint=str(ckpt),
                                            batch_size=8)
    imgs = faces[:8]
    for p in preds.values():
        p.warmup()
    # kernels a UNet forward launches (CUPTI, torch.profiler), the int8
    # default beside bf16, with the quantized weights already kept
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    x = torch.randn(8, 6, 128, 128, device=dev)
    t = torch.full((8, 1), 0.5, device=dev)
    fwd_launches = {}
    for mode in ("int8", "bf16"):
        unet = preds[mode].modules.unet
        with torch.no_grad():
            unet(x, t, quant=mode == "int8")
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                unet(x, t, quant=mode == "int8")
                torch.cuda.synchronize()
        fwd_launches[mode] = sum(e.count for e in _kernels(prof))
    print(f"    kernel launches of one UNet forward at batch 8: int8 "
          f"{fwd_launches['int8']}, bf16 {fwd_launches['bf16']}")
    quantizes = Int8Conv.weight_quantizes
    times: dict = {m: [] for m in preds}
    for _ in range(3):
        for mode in ("int8", "bf16"):
            times[mode].append(serve(preds[mode], imgs)[1])
    require(Int8Conv.weight_quantizes == quantizes,
            f"{Int8Conv.weight_quantizes - quantizes} weight quantizes "
            f"during the int8 requests: the weights are kept per version")
    med = {m: float(np.median(t)) for m, t in times.items()}
    print(f"    requests of 8 in turns (int8, bf16) x 3: int8 "
          f"{[round(t * 1e3, 1) for t in times['int8']]} ms, median "
          f"{8 / med['int8']:.2f} faces/s; bf16 "
          f"{[round(t * 1e3, 1) for t in times['bf16']]} ms, median "
          f"{8 / med['bf16']:.2f} faces/s; int8 / bf16 time "
          f"{med['int8'] / med['bf16']:.3f}")
    print(f"    no weight quantized during the requests (Int8Conv's cache)")
    print(f"    {smi_line()}")
    return runs["int8"][1], fwd_launches


def write_flame_assets(flame, d: Path) -> tuple[Path, Path]:
    """``flame`` as the FLAME2020 files ``load_flame`` reads (the model
    pickle and the landmark embedding), so a config points at them."""
    import pickle

    d.mkdir(parents=True, exist_ok=True)

    def np_(t):
        return t.detach().cpu().numpy()

    V = flame.n_vertices
    P = flame.posedirs.shape[0]
    parents = np.asarray(flame.parents, np.int64)
    model = {"f": np_(flame.faces), "v_template": np_(flame.v_template),
             "shapedirs": np_(flame.shapedirs),
             "posedirs": np_(flame.posedirs).T.reshape(V, 3, P),
             "kintree_table": np.stack([parents, np.arange(len(parents))]),
             "J_regressor": np_(flame.J_regressor),
             "weights": np_(flame.lbs_weights)}
    lmk = {"static_lmk_faces_idx": np_(flame.lmk_faces_idx),
           "static_lmk_bary_coords": np_(flame.lmk_bary_coords),
           "dynamic_lmk_faces_idx": np_(flame.dynamic_lmk_faces_idx),
           "dynamic_lmk_bary_coords": np_(flame.dynamic_lmk_bary_coords),
           "full_lmk_faces_idx": np_(flame.full_lmk_faces_idx),
           "full_lmk_bary_coords": np_(flame.full_lmk_bary_coords)}
    with open(d / "generic_model.pkl", "wb") as f:
        pickle.dump(model, f)
    np.save(d / "landmark_embedding.npy", lmk, allow_pickle=True)
    return d / "generic_model.pkl", d / "landmark_embedding.npy"


def _merge(base: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def trainer_workspace(flame, root: Path) -> tuple[Path, float]:
    """Phase 10's data under ``root``: a synthetic joint root (8 actors ×
    4 images, 224² crops, 16 → 128, n_shape 300), two val faces, the FLAME
    files of ``flame``, and an overlay of the flagship YAML that points
    there (width and depth unchanged; the DDIM-25 hand-off and val
    sampler, checkpoints every 2 steps keeping 2, ``evaluate_MICA`` every
    2, ``evaluate`` and the train visualisation every 4, a log line every
    2).  Returns the overlay and the seconds the data took."""
    import yaml

    from sr3d_torch.data.synthetic import (
        generate_synthetic_faces,
        generate_synthetic_joint_root,
    )

    t0 = time.perf_counter()
    generate_synthetic_joint_root(root / "joint", name="SYNTH", n_actors=8,
                                  imgs_per_actor=4, img_res=224, lr_res=16,
                                  hr_res=128, n_shape=300, n_exp=100, seed=0)
    generate_synthetic_faces(root / "val", n=2, l_res=16, r_res=128, seed=1)
    model_pkl, lmk_npy = write_flame_assets(flame, root / "flame")
    t_data = time.perf_counter() - t0
    over = {
        "name": "trainer_smoke", "output_dir": str(root / "out"),
        "mica": {"datasets": {"root": str(root / "joint"),
                              "training_data": ["SYNTH"],
                              "eval_data": ["SYNTH"]},
                 "model": {"flame_model_path": str(model_pkl),
                           "flame_lmk_embedding_path": str(lmk_npy)},
                 "train": {"eval_steps": 2}},
        "sr": {"datasets": {"val": {"dataroot": str(root / "val")}},
               "model": {"diffusion": {
                   "train_sampler": "ddim", "train_ddim_steps": 25,
                   "sampler": "ddim", "ddim_steps": 25,
                   "sampler_init": "marginal"}}},
        "train": {"checkpoint_steps": 2, "checkpoint_max_keep": 2,
                  "eval_steps": 4, "log_steps": 2, "vis_steps": 4,
                  "val_n_img": 1},
    }
    overlay = root / "overlay.yml"
    with open(CONFIG) as f:
        base = yaml.safe_load(f)
    overlay.write_text(yaml.safe_dump(_merge(base, over)))
    return overlay, t_data


def phase_trainer(dev, flame, tmp: Path, bare_step_s: float
                  ) -> tuple[dict, Path]:
    """The joint Trainer as users run it, at the flagship config's full
    width: a synthetic joint root (8 actors × 4 images, 224² crops, 16 →
    128, n_shape 300) and two val faces written by the port's generators,
    the FLAME files of ``flame``; an overlay of the flagship YAML that
    points there (width and depth unchanged; the DDIM-25 hand-off and val
    sampler, checkpoints every 2 steps keeping 2, ``evaluate_MICA`` every
    2, ``evaluate`` and the train visualisation every 4, a log line every
    2); then ``sr3d_torch.cli.main.main``: train 4 steps, train 2 more
    (a resume at step 4 that ends at 6), ``-p val -ckt`` step 6's
    checkpoint; then ``Predictor.from_config`` serves that checkpoint, a
    request of 8.  Checks the files of the JAX Trainer, finite losses, the
    resume, the kernels launched; prints the Trainer's s/step, the share
    of the loop spent waiting on the loader, the checkpoints' write and
    read times and sizes, val s/face and peak memory.  Returns the
    launches of the phase and the overlay (phase 11 trains on its data)."""
    from sr3d_torch.cli.main import main as cli_main
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.serve import Predictor

    root = tmp / "trainer"
    overlay, t_data = trainer_workspace(flame, root)
    out = root / "out" / "trainer_smoke"
    print(f"[10] Trainer: joint root (8 actors x 4 images, 224^2, "
          f"16->128), 2 val faces and the FLAME files written in "
          f"{t_data:.1f} s; overlay of {CONFIG.name} (widths and depth "
          f"unchanged, DDIM-25 hand-off and val sampler)")

    import gc

    plain0 = PLAIN_GN["calls"]
    reset_launch_counts()
    walls, peaks = {}, {}
    for tag, argv in (
            ("train 4", ["-p", "train", "-c", str(overlay),
                         "--max-steps", "4"]),
            ("resume +2", ["-p", "train", "-c", str(overlay),
                           "--max-steps", "2"]),
            ("val", ["-p", "val", "-c", str(overlay), "-ckt",
                     str(out / "checkpoint" / "ckpt_0000000006.npz")])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        require(cli_main(argv) == 0, f"cli main {tag}")
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        peaks[tag] = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()

    # every file of the directory: the rotated set, no temporary file
    ckpts = sorted(p.name for p in (out / "checkpoint").iterdir())
    require(ckpts == ["ckpt_0000000004.npz", "ckpt_0000000006.npz"],
            f"rotated checkpoints {ckpts}")
    res = out / "results" / "step_4" / "00000"
    want = [out / "best_model.npz", out / "best_model.txt",
            out / "best_models" / "best_model_3.npz",
            out / "val_metrics.jsonl", out / "logs" / "full_config.yaml",
            out / "logs" / "config.yml", out / "logs" / "metrics.jsonl",
            out / "train_images" / "1_4" / "train_3d.jpg",
            *(res / n for n in ("mesh.ply", "mesh.obj", "identity.npy",
                                "kpt7.npy", "kpt68.npy", "00000_sr.png",
                                "00000_hr.png", "00000_inf.png",
                                "00000_lr.png")),
            out / "results" / "step_6" / "00000" / "mesh.ply"]
    missing = [str(p.relative_to(out)) for p in want if not p.exists()]
    require(not missing, f"Trainer files missing: {missing}")
    rows = [json.loads(x) for x in
            (out / "logs" / "metrics.jsonl").read_text().splitlines()]

    def tagged(tag):
        return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]

    losses = tagged("train/loss")
    require([s for s, _ in losses] == [2, 4, 6],
            f"train/loss logged at steps {[s for s, _ in losses]}; a resume "
            f"at step 4 that ends at 6 logs 2, 4, 6")
    require(all(math.isfinite(v) for _, v in tagged("train/loss")
                + tagged("train/l_sr") + tagged("train/l_mica")
                + tagged("val_mica/combined")), "non-finite losses")
    val = [json.loads(x) for x in
           (out / "val_metrics.jsonl").read_text().splitlines()]
    require([v["step"] for v in val] == [4, 6]
            and all(math.isfinite(v["psnr"]) for v in val),
            f"val_metrics {val}")
    from sr3d_torch.train.checkpoint import npz_leaves
    leaves = npz_leaves(out / "checkpoint" / "ckpt_0000000006.npz")
    require(int(leaves[1]) == 6 and int(leaves[2]) == 6,
            f"step 6's checkpoint holds global_step {int(leaves[1])}, "
            f"state.step {int(leaves[2])}")
    require(counts["gn_swish"] > 0 and counts["spatial_attention"] > 0,
            f"the Trainer ran the plain versions: launches {counts}")
    require_gn_backward(counts, plain0, "phase 10")

    # train -> checkpoint -> serve, all written by the port
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    cfg = update_cfg(get_cfg_defaults(), str(overlay))
    t0 = time.perf_counter()
    p = Predictor.from_config(
        cfg, checkpoint=str(out / "checkpoint" / "ckpt_0000000006.npz"),
        batch_size=8)
    t_load = time.perf_counter() - t0
    lr = np.random.RandomState(3).randint(0, 256, (8, 16, 16, 3), np.uint8)
    served, t_serve = serve(p, lr)
    check_outputs(served, 8, flame.n_vertices, 300)
    del p

    per_it = dict(tagged("train/sec_per_it"))
    wait = sum(v for _, v in tagged("perf/loader_wait_s"))
    loop = sum(v for _, v in tagged("perf/loop_s"))
    cadence = sum(v for _, v in tagged("perf/cadence_s"))
    snaps, waits, writes, mib = (dict(tagged(f"perf/ckpt_{k}")) for k in (
        "snapshot_s", "wait_s", "write_s", "write_mib"))
    require(sorted(snaps) == sorted(writes) == [2, 4, 6],
            f"checkpoints saved at {sorted(snaps)}, written at "
            f"{sorted(writes)}; the Trainer saves at 2, 4 and 6")
    reads = tagged("perf/ckpt_read_s")
    per_face = tagged("perf/val_s_per_face")
    print(f"    cli main: train 4 steps {walls['train 4']:.1f} s, resume at "
          f"step 4 to 6 {walls['resume +2']:.1f} s, -p val -ckt step 6 "
          f"{walls['val']:.1f} s (each builds its Trainer)")
    print(f"    s/step (log windows, checkpoints and evals excluded): "
          f"steps 1-2 {per_it[2]:.3f}, 3-4 {per_it[4]:.3f}, 5-6 "
          f"{per_it[6]:.3f}; phase 6's bare step {bare_step_s:.3f} s")
    kinds = {k: sum(v for _, v in tagged(f"perf/{k}_s"))
             for k in ("checkpoint", "evaluate_mica", "evaluate", "vis")}
    print(f"    loader wait {wait:.3f} s of {loop - cadence:.3f} s of "
          f"training ({100 * wait / (loop - cadence):.1f}%); loop "
          f"{loop:.1f} s with {cadence:.1f} s of cadenced work: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in kinds.items()))
    print("    checkpoints in the background, step: blocking (of it the "
          "wait on the write before) / the writer's own time, size: "
          + ", ".join(f"{k}: {snaps[k]:.3f} ({waits[k]:.3f}) / "
                      f"{writes[k]:.2f} s, {mib[k]:.0f} MiB"
                      for k in sorted(snaps))
          + "; reads " + ", ".join(f"{v:.2f}" for _, v in reads) + " s")
    print(f"    evaluate (DDIM-25, exports): "
          f"{', '.join(f'{v:.3f}' for _, v in per_face)} s/face; peak "
          f"device memory " + ", ".join(f"{k} {v:.2f} GiB"
                                        for k, v in peaks.items()))
    print(f"    served the port's own step-6 checkpoint: from_config "
          f"{t_load:.2f} s, request of 8 {t_serve * 1e3:.1f} ms, outputs "
          f"checked")
    print(f"    files of the JAX Trainer present; losses finite; launches "
          f"{counts}")
    print(f"    {smi_line()}")
    phase_background_checkpoint(dev, flame, root / "background")
    require_gn_backward(launch_counts(), plain0, "phase 10 (b)")
    return counts, overlay


def _npz_differing(a: Path, b: Path) -> set[int]:
    """The indices of the ``leaf_i`` that differ (value or dtype) between
    two ``.npz`` files with the same leaves, read one leaf at a time."""
    with np.load(a) as fa, np.load(b) as fb:
        require(sorted(fa.files) == sorted(fb.files),
                f"{a.name} and {b.name} hold other leaves")
        return {int(k[5:]) for k in fa.files
                if fa[k].dtype != fb[k].dtype
                or not np.array_equal(fa[k], fb[k])}


def _state_blocks(mods, state) -> dict[str, range]:
    """The leaf indices of each block of a train-state file."""
    from sr3d_torch.train.checkpoint import jax_tree_flatten, train_state_tree

    tree = train_state_tree(mods, state, {"epoch": 0, "global_step": 0},
                            tensors=True)
    step, params, stats, opt, ema = tree["state"]
    parts = [("meta", tree["meta"]), ("step", step), ("params", params),
             ("arcface_stats", stats)]
    if state.grad_accum > 1:
        mini, updates, inner, acc, _ = opt
        parts += [("counts", (mini, updates)), ("adam", inner),
                  ("acc_grads", acc)]
    else:
        parts.append(("adam", opt))
    parts.append(("ema", ema))
    out, at = {}, 0
    for name, part in parts:
        n = len(jax_tree_flatten(part)[0])
        out[name], at = range(at, at + n), at + n
    return out


def phase_background_checkpoint(dev, flame, tmp: Path,
                                config: Path = CONFIG) -> None:
    """(10 b) The checkpoint manager's background save at the flagship's
    full width, model2 with the DDIM-25 hand-off, at ``grad_accum`` 2 so
    that the file holds the accumulated gradients too: after 7 steps (one
    micro-step into an update) a synchronous save of the state, then a
    background save, and at once the next steps, in place, while the
    writer runs; then ``wait()``.  The file must equal the synchronous one
    leaf for leaf; the control, a synchronous save after those steps, must
    differ in the parameters, the Adam moments, the accumulated gradients
    and the EMA.  A second save reuses the pinned buffers.  Prints each
    save's blocking time split by cause, the writer's time, and the s/step
    of the steps that overlap a write against those that do not."""
    from sr3d_torch.train.checkpoint import (CheckpointManager,
                                             save_train_state)
    from sr3d_torch.train.joint import (build_joint, init_train_state,
                                        make_train_step)

    cfg, batch = train_setup(config)
    cfg.tpu.grad_accum = 2
    mods = build_joint(cfg, flame=flame, init_seed=0, device=dev)
    state = init_train_state(mods, cfg)
    step = make_train_step(cfg.sr.train.ema_scheduler)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one() -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(mods, state, batch, generator=gen)
        require(math.isfinite(float(met["loss"])), "loss not finite")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(3):
        one()                               # cuDNN plans, the first update
    quiet = [one() for _ in range(4)]
    require(state.mini_step == 1, f"mini_step {state.mini_step}")
    meta = {"epoch": 0, "global_step": state.step}
    t0 = time.perf_counter()
    before = save_train_state(tmp / "sync_before.npz", mods, state, meta)
    t_sync = time.perf_counter() - t0
    mgr = CheckpointManager(tmp / "checkpoint", max_to_keep=2)
    t0 = time.perf_counter()
    path = mgr.save(state.step, mods, state, meta)
    t_block = time.perf_counter() - t0
    held = not path.exists()
    saves = [(t_block, mgr.last_wait_s, mgr.last_snapshot_s,
              mgr.last_alloc_bytes)]
    overlap = []
    while mgr.in_flight and len(overlap) < 16:
        overlap.append(one())               # in place, the write in flight
    mgr.wait()
    require(held and overlap, f"the write was not in flight: file at "
            f"return {not held}, {len(overlap)} steps overlapped it")
    same = _npz_differing(path, before)
    after = save_train_state(tmp / "sync_after.npz", mods, state, meta)
    late = _npz_differing(after, before)
    blocks = _state_blocks(mods, state)
    moved = [k for k, r in blocks.items() if late & set(r)]
    require(not same, f"the background file differs from the state at "
            f"save in leaves {sorted(same)[:10]}")
    require({"params", "adam", "acc_grads", "ema"} <= set(moved),
            f"the control (a save after the steps) differs only in {moved}")
    # the pinned buffers reused
    t0 = time.perf_counter()
    mgr.save(state.step, mods, state, dict(meta, global_step=state.step))
    saves.append((time.perf_counter() - t0, mgr.last_wait_s,
                  mgr.last_snapshot_s, mgr.last_alloc_bytes))
    after2 = one()
    mgr.wait()
    written = mgr.poll()
    files = sorted(p.name for p in (tmp / "checkpoint").iterdir())
    require(len(written) == 2 and len(files) == 2
            and all(f.endswith(".npz") for f in files),
            f"writes {written}, files {files}")
    mib = written[0].nbytes / 2 ** 20
    print(f"[10b] background checkpoint, flagship width, grad_accum 2, "
          f"{mib:.0f} MiB: a synchronous save {t_sync:.2f} s; "
          + "; ".join(f"save {i + 1} returned in {b:.3f} s (wait on the "
                      f"write before {w:.3f}, snapshot {sn:.3f} s, "
                      f"{a / 2 ** 20:.0f} MiB pinned allocated), writer "
                      f"{x.seconds:.2f} s"
                      for i, ((b, w, sn, a), x) in
                      enumerate(zip(saves, written))))
    print(f"    s/step: {len(quiet)} steps with no write "
          f"{', '.join(f'{v:.3f}' for v in quiet)} (mean "
          f"{sum(quiet) / len(quiet):.3f}); {len(overlap)} overlapping a "
          f"write {', '.join(f'{v:.3f}' for v in overlap)} (mean "
          f"{sum(overlap) / len(overlap):.3f}); after the second save "
          f"{after2:.3f}")
    print(f"    the background file equals the synchronous save before the "
          f"{len(overlap)} steps leaf for leaf ({len(blocks['ema'])} EMA, "
          f"{len(blocks['acc_grads'])} acc_grads leaves among "
          f"{max(r.stop for r in blocks.values())}); the control (a save "
          f"after them) differs in {moved}")
    for f in (before, after, *(w.path for w in written)):
        f.unlink()


def _unet_launches(unet, remat: bool) -> tuple[int, int, int]:
    """GN+Swish, attention and GN+Swish backward launches of one train step
    of ``unet``: one per module forward; under remat the checkpointed
    blocks' (all but ``final_conv``'s GN) once more in the backward; one
    backward per GN+Swish module."""
    from sr3d_torch.models.sr3_unet import GroupNormSwish, SelfAttention

    gn = [n for n, m in unet.named_modules() if isinstance(m, GroupNormSwish)]
    attn = sum(isinstance(m, SelfAttention) for m in unet.modules())
    again = remat * sum(not n.startswith("final_conv") for n in gn)
    return len(gn) + again, attn * (1 + remat), len(gn)


def _want(gn: int, attn: int, bwd: int = 0) -> dict:
    return {"gn_stats": 0, "gn_swish": gn, "gn_swish_backward": bwd,
            "spatial_attention": attn, "conv3x3": 0,
            "fused_gn_swish_conv3x3": 0, "int8_conv": 0}


def _jsonl(path: Path, tag: str) -> list[tuple[int, float]]:
    return [(r["step"], r["value"]) for r in map(
        json.loads, path.read_text().splitlines()) if r["tag"] == tag]


def _cli_timed(cli_main, argv: list[str]) -> tuple[dict, float, float]:
    """One CLI call: its kernel launches, wall seconds and peak device
    memory (GiB)."""
    import gc

    from sr3d_torch.kernels import launch_counts, reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    require(cli_main(argv) == 0, f"cli main {argv}")
    torch.cuda.synchronize()
    return (launch_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _profiled_sr_step(m, dev, hi: int) -> tuple[tuple, tuple]:
    """Two warm-up SR-only steps of ``m`` at B = 2, one timed, one under
    ``torch.profiler``: ((wall s, device busy % of it), (GN+Swish backward
    calls, host ms, % of the profiled step))."""
    from torch.profiler import ProfilerActivity, profile

    from sr3d_torch.profile_train import _device_us, _kernels

    st = m.init_state()
    step = m.make_train_step()
    rng = np.random.RandomState(5)
    b = {k: torch.from_numpy(rng.uniform(-1, 1, (2, hi, hi, 3))
                             .astype(np.float32)).to(dev)
         for k in ("HR", "SR")}
    g = torch.Generator(device=dev)

    def one(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(st, b, generator=g.manual_seed(i))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    one(0), one(1)
    wall = one(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof = one(3)
    ev = prof.key_averages()
    kernel_us = sum(_device_us(e) for e in _kernels(prof))
    gb = [e for e in ev if e.key == "gn_swish.backward"
          and e.device_type == torch.autograd.DeviceType.CPU]
    require(gb, "no gn_swish.backward range in the profile")
    host_ms = float(gb[0].cpu_time_total) / 1e3
    return ((wall, 100 * kernel_us / 1e6 / wall),
            (gb[0].count, host_ms, 100 * host_ms / 1e3 / t_prof))


def phase_staged(dev, tmp: Path, joint_overlay: Path) -> dict:
    """The staged workflow's branch trainers at the flagship config's full
    width, on phase 10's overlay (its joint root, FLAME files, DDIM-25
    hand-off):

    (a) SR-only pretraining through ``cli.main --sr-only`` on an LR/HR
        image root (8 faces, 16 → 128) at the config's batch of 2: 4 steps
        with a pair at step 4, then a call that resumes to step 6;
    (b) the hand-over: the joint Trainer warm-started from (a)'s step-6
        pair (``sr.pretrained_model_path``), 2 steps;
    (c) the DDPM family (``which_model_G: ddpm``): 2 ``SRModel`` steps at
        B = 2, then a DDIM-25 request of 8;
    (d) MICA-only: ``MicaTrainer.fit`` 4 steps (2 actors × K 2) with the
        ``Validator`` every 2, then a resume to step 6;
    (e) the alternating trainer through ``cli.main --legacy``: 3 steps
        with the DDIM-25 sampler, then a resumed call of one step with the
        config's own ancestral T = 600 loop.

    Checks the files, counters, finite losses, moved parameters and every
    call's launches against a count from the UNet's modules; prints
    s/step, peak memory, the pairs' sizes and write / read times, and for
    one SR-only step under ``torch.profiler`` the device's busy share and
    the GN+Swish backward's host share.  Returns the launches of (a) and
    of (e)."""
    import copy
    import gc

    import yaml

    from sr3d_torch import data as data_lib
    from sr3d_torch.cli.main import main as cli_main
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.data.synthetic import generate_synthetic_faces
    from sr3d_torch.eval.validator import Validator
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.train import mica_only
    from sr3d_torch.train.checkpoint import (
        jax_tree_flatten,
        npz_leaves,
        optimizer_tree,
        sr_layout,
    )
    from sr3d_torch.train.joint import build_joint
    from sr3d_torch.train.sr_only import SRModel
    from sr3d_torch.train.trainer import Trainer
    from sr3d_torch.utils.bridge import state_dict_to_flax

    t_phase = time.perf_counter()
    plain0 = PLAIN_GN["calls"]
    root = tmp / "staged"
    root.mkdir()
    with open(joint_overlay) as f:
        base = yaml.safe_load(f)

    def overlay(name: str, over: dict) -> Path:
        path = root / f"{name}.yml"
        path.write_text(yaml.safe_dump(_merge(copy.deepcopy(base), _merge(
            {"name": name, "output_dir": str(root / "out")}, over))))
        return path

    def cfg_of(path: Path):
        return update_cfg(get_cfg_defaults(), str(path))

    def unet_leaves(unet) -> list:
        return jax_tree_flatten({"params": state_dict_to_flax(dict(
            unet.named_parameters()))})[0]

    # (a) SR-only pretraining through the CLI
    p_sr = overlay("sr_only_smoke", {
        "sr": {"datasets": {"train": {"dataroot": str(root / "lrhr")}}},
        "train": {"checkpoint_steps": 4, "log_steps": 1}})
    cfg = cfg_of(p_sr)
    require(int(cfg.sr.datasets.train.batch_size) == 2
            and bool(cfg.tpu.train_remat), "the flagship's SR batch / remat")
    lo, hi = (int(cfg.sr.datasets.train.l_resolution),
              int(cfg.sr.datasets.train.r_resolution))
    T = int(cfg.sr.model.beta_schedule.val.n_timestep)
    S = min(25, T)                # the DDIM steps
    generate_synthetic_faces(root / "lrhr", n=8, l_res=lo, r_res=hi, seed=2)
    calls = {}
    for tag, steps in (("4 steps", "4"), ("resume +2", "2")):
        calls[tag] = _cli_timed(cli_main, ["--sr-only", "-c", str(p_sr),
                                           "--max-steps", steps])
    out = root / "out" / "sr_only_smoke"
    ck = out / "checkpoint_sr"
    names = sorted(p.name for p in ck.glob("*.npz"))
    require(names == ["I4_E1_gen.npz", "I4_E1_opt.npz", "I6_E1_gen.npz",
                      "I6_E1_opt.npz"], f"SR-only pairs {names}")
    with np.load(ck / "I6_E1_opt.npz") as d:
        require((int(d["iter"]), int(d["epoch"]), int(d["leaf_0"]))
                == (6, 1, 6), "SR-only counters (iter, epoch, Adam count)")
    fresh = SRModel(cfg, device=dev)
    n_gn, n_attn, n_bwd = _unet_launches(fresh.unet, True)  # a train step
    fwd_gn, fwd_attn, _ = _unet_launches(fresh.unet, False)  # a sampling step
    for tag, n in (("4 steps", 4), ("resume +2", 2)):
        require(calls[tag][0] == _want(n * n_gn, n * n_attn, n * n_bwd),
                f"SR-only {tag} launches {calls[tag][0]}, want {n} x "
                f"({n_gn}, {n_attn}, {n_bwd})")
    init = unet_leaves(fresh.unet)
    busy, gn_bwd = _profiled_sr_step(fresh, dev, hi)
    del fresh
    g4, g6 = npz_leaves(ck / "I4_E1_gen.npz"), npz_leaves(ck / "I6_E1_gen.npz")
    moved = lambda a, b: sum(not np.array_equal(x, y) for x, y in zip(a, b))
    require(moved(init, g4) == len(init) and moved(g4, g6) > 0,
            f"SR-only parameters moved: {moved(init, g4)} of {len(init)} "
            f"leaves by step 4, {moved(g4, g6)} between 4 and 6")
    logs = out / "logs" / "metrics.jsonl"
    l_pix = _jsonl(logs, "train/l_pix")
    require([s for s, _ in l_pix] == [1, 2, 3, 4, 5, 6]
            and all(math.isfinite(v) for _, v in l_pix),
            f"SR-only l_pix {l_pix}")
    per = dict(_jsonl(logs, "train/sec_per_it"))
    writes = _jsonl(logs, "perf/ckpt_write_s")
    mib = _jsonl(logs, "perf/ckpt_write_mib")
    reads = _jsonl(logs, "perf/ckpt_read_s")
    sr_counts = {k: calls["4 steps"][0][k] + calls["resume +2"][0][k]
                 for k in calls["4 steps"][0]}
    print(f"[11] staged workflow, full width ({CONFIG.name})")
    print(f"  (a) --sr-only, LR/HR root of 8 faces {lo}->{hi}, batch 2, remat: "
          f"4 steps {calls['4 steps'][1]:.1f} s, resume to 6 "
          f"{calls['resume +2'][1]:.1f} s (each builds its model); s/step "
          f"{', '.join(f'{per[i]:.3f}' for i in range(1, 7))} (steps 1-6; "
          f"1 and 5 first of a call); peak {calls['4 steps'][2]:.2f} / "
          f"{calls['resume +2'][2]:.2f} GiB")
    print(f"      pair {mib[0][1]:.0f} MiB, written in "
          f"{', '.join(f'{v:.2f}' for _, v in writes)} s, read in "
          f"{reads[0][1]:.2f} s; l_pix {l_pix[0][1]:.4f} -> "
          f"{l_pix[-1][1]:.4f}; launches {n_gn} GN+Swish, {n_attn} "
          f"attention, {n_bwd} GN+Swish backward a step ({fwd_gn} + "
          f"{n_gn - fwd_gn} recomputed; {fwd_attn} + "
          f"{n_attn - fwd_attn}): {sr_counts}")
    print(f"      one step (B = 2) under torch.profiler: {busy[0]:.3f} s "
          f"wall, the device busy {busy[1]:.1f}% of it; GN+Swish backward "
          f"(the gn_swish_backward kernel) {gn_bwd[0]} calls, host "
          f"{gn_bwd[1]:.1f} ms = {gn_bwd[2]:.1f}% of the profiled step")

    # (b) the hand-over to the joint Trainer
    prefix = str(ck / "I6_E1")
    p_b = overlay("handover_smoke", {
        "sr": {"pretrained_model_path": prefix},
        "mica": {"train": {"eval_steps": 0}},
        "train": {"checkpoint_steps": 0, "eval_steps": 0, "vis_steps": 0,
                  "log_steps": 1}})
    tr = Trainer(cfg_of(p_b), device=dev)
    tr.prepare_data()
    t0 = time.perf_counter()
    require(tr.load_sr_pretrained(prefix), "load_sr_pretrained")
    t_load = time.perf_counter() - t0
    require(all(np.array_equal(a, b) for a, b in
                zip(unet_leaves(tr.modules.unet), g6, strict=True)),
            "the joint UNet differs from the pair's weights")
    moments = jax_tree_flatten(optimizer_tree(
        sr_layout(tr.modules.unet), tr.state, accum=1))[0]
    require(all(np.array_equal(a, b) for a, b in zip(
        moments, npz_leaves(ck / "I6_E1_opt.npz"), strict=True)),
        "the sr group's Adam state differs from the pair's")
    require((tr.global_step, tr.epoch) == (6, 1),
            f"hand-over counters {(tr.global_step, tr.epoch)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.training_step(max_steps=2)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    b_counts = launch_counts()
    tr.metrics_writer.close()
    b_out = root / "out" / "handover_smoke"
    require(tr.global_step == 8 and (b_out / "checkpoint" /
                                     "ckpt_0000000008.npz").exists(),
            f"hand-over: step {tr.global_step}")
    require(b_counts == _want(2 * (n_gn + S * fwd_gn),
                              2 * (n_attn + S * fwd_attn), 2 * n_bwd),
            f"hand-over launches {b_counts}")
    del tr
    print(f"  (b) the joint Trainer from the step-6 pair: UNet bit-equal, "
          f"Adam moments and count transferred, counters (6, 1), pair read "
          f"in {t_load:.2f} s; 2 steps (DDIM-25 hand-off) + checkpoint "
          f"{t_b:.1f} s, global step 8; launches {b_counts}")

    # (c) the DDPM family
    cfg_c = cfg_of(p_sr)
    cfg_c.sr.model.which_model_G = "ddpm"
    d = cfg_c.sr.model.diffusion
    d.sampler, d.ddim_steps, d.ddim_eta, d.sampler_init = \
        "ddim", 25, 1.0, "marginal"
    m = SRModel(cfg_c, device=dev, init_seed=0)
    require(m.time_input == "t" and type(m.unet).__name__ == "DDPMUNet",
            "which_model_G: ddpm")
    st = m.init_state()
    n_params = sum(p.numel() for p in m.unet.parameters()) / 1e6
    step = m.make_train_step()
    g = torch.Generator(device=dev)
    rng = np.random.RandomState(4)
    hr = rng.uniform(-1, 1, (2, hi, hi, 3)).astype(np.float32)
    batch = {"HR": torch.from_numpy(hr).to(dev),
             "SR": torch.from_numpy(hr[:, :, ::-1].copy()).to(dev)}
    before = m.unet.conv_in.weight.detach().clone()
    reset_launch_counts()
    times, losses = [], []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = step(st, batch, generator=g.manual_seed(i))
        losses.append(float(met["l_pix"]))
        times.append(time.perf_counter() - t0)
    c_train = launch_counts()
    d_gn, d_attn, d_bwd = _unet_launches(m.unet, True)
    require(c_train == _want(2 * d_gn, 2 * d_attn, 2 * d_bwd),
            f"DDPM steps' launches {c_train}")
    require(all(math.isfinite(v) for v in losses)
            and not torch.equal(before, m.unet.conv_in.weight),
            f"DDPM steps: l_pix {losses}, parameters moved")
    cond = torch.from_numpy(rng.uniform(-1, 1, (8, hi, hi, 3))
                            .astype(np.float32))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sr = m.make_sampler()(st, cond, generator=g.manual_seed(9))
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    c_sample = launch_counts()
    d_gn, d_attn, _ = _unet_launches(m.unet, False)
    require(c_sample == _want(S * d_gn, S * d_attn),
            f"DDPM DDIM-25 launches {c_sample}")
    require(tuple(sr.shape) == (8, hi, hi, 3)
            and bool(torch.isfinite(sr).all())
            and float(sr.abs().max()) <= 1.0,
            f"DDPM samples: {tuple(sr.shape)}, max |x| "
            f"{float(sr.abs().max())}")
    del m, st, step
    print(f"  (c) DDPM family ({n_params:.1f}M, integer t): 2 steps at B = 2 "
          f"{times[0]:.3f}, {times[1]:.3f} s, l_pix {losses[0]:.4f}, "
          f"{losses[1]:.4f}; DDIM-25 request of 8 {t_sample * 1e3:.1f} ms, "
          f"samples finite in [-1, 1]; launches {c_train} / {c_sample}")

    # (d) MICA-only
    gc.collect()
    torch.cuda.empty_cache()
    cfg_d = cfg_of(overlay("mica_smoke", {}))
    mods = build_joint(cfg_d, device=dev, init_seed=0)
    loader = data_lib.BatchLoader(
        data_lib.build_train(cfg_d),
        batch_size=int(cfg_d.mica.datasets.batch_size), shuffle=True,
        seed=0, num_workers=int(cfg_d.mica.datasets.num_workers))
    val = Validator(mods, mica_only.make_mica_predict(),
                    {"SYNTH": data_lib.build_val(cfg_d)})
    results = []
    run = val.run
    val.run = lambda state: results.append(run(state)) or results[-1]
    mica_dir = root / "mica"
    step_s: list[float] = []

    def timed(step_fn):
        def wrapped(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = step_fn(*a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return r
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt = mica_only.MicaTrainer(cfg_d, mods, validator=val,
                               output_dir=mica_dir)
    mt._step = timed(mt._step)
    mt.fit(loader, max_steps=4, val_steps=2, checkpoint_steps=2,
           log_steps=1, vis_steps=4, snapshot_steps=0, eval_steps=0)
    t_fit = time.perf_counter() - t0
    peak_d = torch.cuda.max_memory_allocated() / 2 ** 30
    mt2 = mica_only.MicaTrainer(cfg_d, mods, output_dir=mica_dir)
    mt2._step = timed(mt2._step)
    mt2.fit(loader, max_steps=6, val_steps=0, checkpoint_steps=0,
            log_steps=1, vis_steps=0, snapshot_steps=0, eval_steps=0)
    leaves = npz_leaves(mica_dir / "model_mica.npz")
    require(mt.global_step == 4 and mt2.global_step == 6
            and int(leaves[1]) == 6 and int(leaves[2]) == 6,
            f"MICA-only steps {mt.global_step}, {mt2.global_step}; file "
            f"{int(leaves[1])}, {int(leaves[2])}")
    want = [mica_dir / "train_images" / f"train_{mt.epoch}.jpg",
            mica_dir / "best_models" / "best_model_3.npz"]
    require(all(p.exists() for p in want) and len(results) == 2
            and all(math.isfinite(r["loss"]) and r["embeddings"].shape[1]
                    == 512 for r in results),
            f"MICA-only vis / best model / val: {[p.exists() for p in want]}"
            f", {[r['loss'] for r in results]}")
    print(f"  (d) MicaTrainer: 4 steps (N = 4) with val at 2, 4, vis, "
          f"checkpoints: {t_fit:.1f} s; resume to 6; s/step "
          f"{', '.join(f'{v:.3f}' for v in step_s)} (steps 1-6); val loss "
          f"{results[0]['loss']:.3f}, {results[1]['loss']:.3f}; "
          f"model_mica.npz "
          f"{(mica_dir / 'model_mica.npz').stat().st_size / 2 ** 20:.0f} "
          f"MiB; train_{mt.epoch}.jpg, best_model_3.npz written; peak "
          f"{peak_d:.2f} GiB (the joint modules, UNet included)")
    del mods, mt, mt2, val, run, loader
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the alternating trainer through the CLI
    calls = {}
    for tag, sampler, steps in (("DDIM-25, 3 steps", "ddim", "3"),
                                ("T=600, resume +1", "ddpm", "1")):
        p_e = overlay("legacy_smoke", {
            "sr": {"model": {"diffusion": {"sampler": sampler}}},
            "train": {"checkpoint_steps": 1000}})
        calls[tag] = _cli_timed(cli_main, ["--legacy", "-c", str(p_e),
                                           "--max-steps", steps])
    e_out = root / "out" / "legacy_smoke"
    names = sorted(p.name for p in (e_out / "checkpoint_sr").glob("*.npz"))
    require(names == ["I3_E0_gen.npz", "I3_E0_opt.npz", "I4_E0_gen.npz",
                      "I4_E0_opt.npz"]
            and int(npz_leaves(e_out / "model_mica.npz")[0]) == 4,
            f"legacy files {names}")
    logs = e_out / "logs" / "metrics.jsonl"
    per = dict(_jsonl(logs, "train/sec_per_it"))
    for tag in ("train/l_pix", "train/l_mica"):
        v = _jsonl(logs, tag)
        require([s for s, _ in v] == [1, 2, 3, 4]
                and all(math.isfinite(x) for _, x in v), f"legacy {tag} {v}")
    for tag, (n, k) in (("DDIM-25, 3 steps", (3, S)),
                        ("T=600, resume +1", (1, T))):
        require(calls[tag][0] == _want(n * (n_gn + k * fwd_gn),
                                       n * (n_attn + k * fwd_attn),
                                       n * n_bwd),
                f"legacy {tag} launches {calls[tag][0]}")
    legacy = {k: sum(c[0][k] for c in calls.values())
              for k in calls["DDIM-25, 3 steps"][0]}
    c3, c1 = calls["DDIM-25, 3 steps"], calls["T=600, resume +1"]
    print(f"  (e) --legacy (N = 4): DDIM-25 call {c3[1]:.1f} s, s/step "
          f"{per[1]:.3f}, {per[2]:.3f}, {per[3]:.3f}; T=600 resumed call "
          f"{c1[1]:.1f} s, its step {per[4]:.3f} s; peak {c3[2]:.2f} / "
          f"{c1[2]:.2f} GiB; launches {legacy}")
    for tag, c in (("SR-only", sr_counts), ("hand-over", b_counts),
                   ("DDPM", c_train), ("legacy", legacy)):
        require_gn_backward(c, plain0, f"phase 11 {tag}")
    print(f"    every training call of phase 11 launched gn_swish_backward "
          f"and ran GN+Swish's plain version no time on the card")
    print(f"    phase 11 in {time.perf_counter() - t_phase:.1f} s; "
          f"{smi_line()}")
    return {"sr_only": sr_counts, "legacy": legacy}


# --------------------------------------------------------------------------
# 12. evaluation and asset tools
# --------------------------------------------------------------------------

def _ref_unet_key(prefix: str, rest: str) -> str:
    """A port UNet parameter name (flax scope names) below a block → the
    reference ``downs.N`` / ``mid.N`` / ``ups.N`` module's name."""
    import re

    rest = re.sub(r"(block[12])\.norm\.scale$", r"\1.block.0.weight", rest)
    rest = re.sub(r"(block[12])\.norm\.bias$", r"\1.block.0.bias", rest)
    rest = re.sub(r"(block[12])\.conv\.", r"\1.block.3.", rest)
    rest = rest.replace("noise_func.noise_func.", "noise_func.noise_func.0.")
    return f"{prefix}.{rest.replace('norm.scale', 'norm.weight')}"


def reference_unet_sd(unet) -> dict:
    """The port SR3 UNet's weights keyed as the reference's ``*_gen.pth``:
    the inverse of ``utils/convert.py::convert_sr3_unet``'s walk (both
    layouts keep torch's OIHW / ``[out, in]`` weights)."""
    prefix = {"conv_in": "downs.0", "mid_0": "mid.0", "mid_1": "mid.1"}
    downs = [n for k, n in unet.plan if k in ("down", "downsample")]
    ups = [n for k, n in unet.plan if k in ("up", "upsample")]
    prefix.update({n: f"downs.{i + 1}" for i, n in enumerate(downs)})
    prefix.update({n: f"ups.{i}" for i, n in enumerate(ups)})
    sd = {}
    for name, p in unet.named_parameters():
        top, rest = name.split(".", 1)
        if top == "noise_level_mlp":
            key = ("noise_level_mlp." + rest.replace("dense0", "1")
                   .replace("dense1", "3"))
        elif top == "final_conv":
            key = ("final_conv." + rest.replace("norm.scale", "block.0.weight")
                   .replace("norm.bias", "block.0.bias")
                   .replace("conv.", "block.3."))
        elif top == "conv_in":
            key = f"downs.0.{rest}"
        else:
            key = _ref_unet_key(prefix[top], rest)
        sd[key] = p.detach().float().cpu().clone()
    return sd


def reference_arcface_sd(arcface) -> dict:
    """The port IResNet's weights and statistics keyed as insightface's
    ``backbone.pth`` (BatchNorm ``running_*`` and ``num_batches_tracked``,
    the ``fc`` input in torch's (c, h, w) order, the pinned ``features``
    scale): the inverse of ``utils/convert.py::convert_arcface``."""
    import re

    leaf = {"scale": "weight", "alpha": "weight", "mean": "running_mean",
            "var": "running_var"}
    sd = {}
    for name, t in [*arcface.named_parameters(), *arcface.named_buffers()]:
        path, last = name.rsplit(".", 1)
        path = re.sub(r"^layer(\d)\.block(\d+)", r"layer\1.\2", path)
        path = path.replace("downsample_conv", "downsample.0") \
            .replace("downsample_bn", "downsample.1")
        t = t.detach().float().cpu().clone()
        if name == "fc.weight":
            c = t.shape[1] // 49
            t = t.reshape(-1, 7, 7, c).permute(0, 3, 1, 2).reshape(
                t.shape[0], -1).contiguous()
        sd[f"{path}.{leaf.get(last, last)}"] = t
        if last == "mean":
            sd[f"{path}.num_batches_tracked"] = torch.tensor(0)
    sd["features.weight"] = torch.ones_like(sd["features.bias"])
    return sd


def reference_mapping_sd(mapping) -> dict:
    """The mapping network keyed as the reference's ``MappingNetwork``
    (``network.i`` + ``output``)."""
    return {name.replace("dense", "network.", 1) if name.startswith("dense")
            else name: p.detach().float().cpu().clone()
            for name, p in mapping.named_parameters()}


def write_reference_assets(root: Path, unet, arcface, mapping,
                           n_vertices: int, seed: int = 0) -> dict:
    """A reference-layout asset tree from port modules: ``insightface/
    backbone.pth``, ``checkpoint/I100_E5_gen.pth`` + ``_opt.pth`` (the
    reference's save format: counters and the torch Adam state, zero
    moments for every parameter), a MICA ``model_mica.tar`` (``arcface``
    and ``flameModel`` with the ``regressor.`` mapping) and ``FLAME2020/``
    from ``write_reference_format_assets``.  Returns their paths."""
    from sr3d_torch.models.flame import write_reference_format_assets

    paths = {"backbone": root / "insightface" / "backbone.pth",
             "sr_gen": root / "checkpoint" / "I100_E5_gen.pth",
             "sr_opt": root / "checkpoint" / "I100_E5_opt.pth",
             "mica_ckpt": root / "model_mica.tar"}
    for p in paths.values():
        p.parent.mkdir(parents=True, exist_ok=True)
    arc = reference_arcface_sd(arcface)
    torch.save(arc, paths["backbone"])
    gen = reference_unet_sd(unet)
    torch.save(gen, paths["sr_gen"])
    state = {i: {"step": torch.tensor(100.0),
                 "exp_avg": torch.zeros_like(v),
                 "exp_avg_sq": torch.zeros_like(v)}
             for i, v in enumerate(gen.values())}
    torch.save({"epoch": 5, "iter": 100, "scheduler": None,
                "optimizer": {"state": state, "param_groups": [{
                    "lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-8,
                    "weight_decay": 0, "amsgrad": False,
                    "params": list(state)}]}}, paths["sr_opt"])
    flame_model = {f"regressor.{k}": v
                   for k, v in reference_mapping_sd(mapping).items()}
    flame_model["generator.v_template"] = torch.zeros(n_vertices, 3)
    torch.save({"arcface": arc, "flameModel": flame_model},
               paths["mica_ckpt"])
    paths.update({k: Path(v) for k, v in write_reference_format_assets(
        str(root / "FLAME2020"), n_vertices=n_vertices, seed=seed).items()})
    return paths


def _lr_pngs(d: Path, n: int, seed: int) -> None:
    from PIL import Image

    from sr3d_torch.data.synthetic import synthetic_face_batch
    from sr3d_torch.ops.image import tensor_to_uint8

    d.mkdir(parents=True)
    faces = tensor_to_uint8(torch.from_numpy(
        synthetic_face_batch(n, 16, seed=seed))).to(torch.uint8).numpy()
    for i, f in enumerate(faces):
        Image.fromarray(f).save(d / f"face_{i:02d}.png")


def _mib(root: Path) -> float:
    return sum(p.stat().st_size for p in root.rglob("*")
               if p.is_file()) / 2 ** 20


def phase_tools(dev, tmp: Path, trainer_ckpt: Path,
                config: Path = CONFIG) -> dict:
    """The tools around the main paths, at the flagship config's full
    widths (``configs/sr_sr3_VGGF2_16_128_model2.yml``: UNet 92.6M,
    iResNet-100, 300 shape coefficients):

    (a) released assets → a served request: a reference-layout asset tree
        fabricated from seeded port modules (insightface
        ``backbone.pth``, the UNet's ``I100_E5_gen.pth`` + ``_opt.pth``, a
        MICA ``.tar``, FLAME2020 files of 5023 vertices from
        ``write_reference_format_assets``, ~1.6 GB) through ``python -m
        sr3d_torch.utils.bootstrap``, then ``--check`` (a subprocess), a
        flipped output byte that ``--check`` must catch; the converted
        UNet served through ``sr3d_torch.serve.main`` (a request of 8,
        DDIM-25, the int8 default: GN+Swish, attention and ``int8_conv``),
        ``Predictor.from_config(checkpoint=)`` on it bit-equal to the same
        weights through ``params=``, the converted ``arcface.npz`` loaded
        by ``load_arcface_npz`` equal to the fabricated backbone;
    (b) NoW: ``python -m sr3d_torch.eval.now_protocol``'s dry run (4
        subjects × 2 pictures rendered from the sphere FLAME, batch 8) and
        a run on those pictures and scans with ``-ckt`` phase 10's
        checkpoint; the prediction and ``evaluate_now`` timed on their
        own; ``Tester.run_stirling`` on an HQ/LQ tree of 4 + 4 pictures;
    (c) dataset tools: ``data/prepare.py --size 16,128 --srpk`` on 16
        faces rendered from the sphere FLAME, a batch of 8 of the packed
        stores (``SrpkImageDataset``) and one of the PNG dirs
        (``LRHRDataset``) onto the card through ``prefetch_to_device``; ``data/creation.py --raw-root`` on a raw
        tree of one source (4 actors × 4 of those faces, a FLAME parameter
        file each) and one batch of 2 actors of the ``JointFaceDataset``
        over its index and blobs (with the SR triplets the dataset reads
        beside them, which neither package's creation tool writes) onto
        the card.

    Returns the launches of (a)'s served request."""
    import yaml
    from PIL import Image

    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.data import creation, prepare
    from sr3d_torch.data.joint import JointFaceDataset
    from sr3d_torch.data.lrhr import LRHRDataset
    from sr3d_torch.data.pipeline import BatchLoader, prefetch_to_device
    from sr3d_torch.data.srpk import SrpkImageDataset
    from sr3d_torch.data.synthetic import render_flame_views
    from sr3d_torch.eval import now_protocol
    from sr3d_torch.eval.tester import Tester
    from sr3d_torch.kernels import launch_counts, reset_launch_counts
    from sr3d_torch.models.flame import sphere_flame
    from sr3d_torch.serve import Predictor, apply_serving_flags
    from sr3d_torch.serve import main as serve_main
    from sr3d_torch.train.checkpoint import load_arcface_npz, npz_leaves
    from sr3d_torch.train.joint import build_joint
    from sr3d_torch.train.mica_only import make_mica_predict
    from sr3d_torch.utils import bootstrap
    from sr3d_torch.utils.bridge import export_jax_params

    t_phase = time.perf_counter()
    root = tmp / "tools"
    smi = smi_line()

    # (a) the asset tree, converted, checked, served
    cfg = update_cfg(get_cfg_defaults(), str(config))
    m = cfg.mica.model
    n_shape, lo, hi = (int(m.n_shape), int(cfg.sr.datasets.val.l_resolution),
                       int(cfg.sr.datasets.val.r_resolution))
    src = build_joint(cfg, init_seed=1, device=dev)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():      # ArcFace's statistics off their 0/1 init
        for name, b in src.arcface.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) + 0.5
                    if name.endswith("var")
                    else torch.randn(b.shape, generator=g) * 0.1)
    assets = root / "assets"
    t0 = time.perf_counter()
    write_reference_assets(assets, src.unet, src.arcface, src.mapping,
                           n_vertices=5023)
    t_fab, in_mib = time.perf_counter() - t0, _mib(assets)
    out = root / "converted"
    t0 = time.perf_counter()
    require(bootstrap.main([
        "--assets", str(assets), "--out", str(out), "--image-size", str(hi),
        "--attn-res", ",".join(str(x) for x in cfg.sr.model.unet.attn_res),
        "--n-shape", str(n_shape), "--mapping-hidden", str(m.mapping_layers),
        "--arcface-layers", ",".join(str(x) for x in m.arcface_layers)])
        == 0, "the bootstrap failed")
    t_boot, out_mib = time.perf_counter() - t0, _mib(out)
    manifest = json.loads((out / "manifest.json").read_text())
    kinds = [e["kind"] for e in manifest["artifacts"]]
    require(kinds == ["flame/generic_model.pkl",
                      "flame/landmark_embedding.npy",
                      "flame/FLAME_masks.pkl", "arcface", "sr3_unet",
                      "arcface", "mapping"], f"manifest kinds {kinds}")
    sr_entry = manifest["artifacts"][4]
    require(sr_entry["structure"]["attn_res"] == [-1]
            and sr_entry["structure"]["channel_mults"]
            == list(cfg.sr.model.unet.channel_multiplier)
            and sr_entry["opt_counters"]["iter"] == 100
            and manifest["artifacts"][0]["n_vertices"] == 5023,
            f"the converted UNet's entry {sr_entry}")
    check = [sys.executable, "-m", "sr3d_torch.utils.bootstrap",
             "--assets", str(assets), "--out", str(out), "--check"]
    t0 = time.perf_counter()
    proc = subprocess.run(check, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    t_check = time.perf_counter() - t0
    require(proc.returncode == 0 and proc.stdout.count("ok ") == 7,
            f"--check: {proc.returncode} {proc.stdout} {proc.stderr}")
    victim = out / "arcface_from_tar.npz"
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    proc = subprocess.run(check, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    require(proc.returncode == 1 and "CORRUPT" in proc.stdout,
            f"--check passed a corrupted output: {proc.stdout}")
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    require(bootstrap.check_manifest(out), "--check after the repair")
    shutil.rmtree(assets)
    print(f"[12] tools: reference-layout assets ({in_mib:.0f} MiB: "
          f"iResNet-100 backbone.pth, the flagship UNet's I100_E5_gen.pth "
          f"+ _opt.pth, a MICA .tar, FLAME2020 at 5023 vertices) written in "
          f"{t_fab:.1f} s; bootstrap {t_boot:.2f} s -> {out_mib:.0f} MiB "
          f"(manifest of 7, 'structural'/'loaded'); --check "
          f"{t_check:.2f} s (a subprocess), a flipped byte caught; {smi}")

    lr_dir = root / "lr"
    _lr_pngs(lr_dir, 8, seed=4)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(serve_main(["-c", str(config), "-ckt", str(out / "sr_gen.npz"),
                        "--input", str(lr_dir), "--out", str(root / "served"),
                        "--sampler", "ddim", "--steps", "25",
                        "--batch", "8"]) == 0, "serving the converted UNet")
    torch.cuda.synchronize()
    t_cli, counts = time.perf_counter() - t0, launch_counts()
    want = {"gn_stats": 0, "gn_swish": 55 * 25, "gn_swish_backward": 0,
            "spatial_attention": 25, "conv3x3": 0,
            "fused_gn_swish_conv3x3": 0, "int8_conv": 58 * 25}
    require(counts == want, f"served request launches {counts}, want {want}")
    require(len(list((root / "served").rglob("*_sr.png"))) == 8,
            "the served bundles")
    c = apply_serving_flags(cfg.clone(), sampler="ddim", steps=25, int8=None)
    p_ck = Predictor.from_config(c, checkpoint=str(out / "sr_gen.npz"),
                                 batch_size=8)
    tree = export_jax_params(p_ck.modules)
    tree["sr"] = export_jax_params(src)["sr"]
    p_par = Predictor.from_config(c, params=tree, batch_size=8)
    req = np.stack([np.asarray(Image.open(p)) for p in
                    sorted(lr_dir.glob("*.png"))])
    outs, t_req = {}, []
    for tag, p in (("checkpoint", p_ck), ("params", p_par)):
        p.warmup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tag] = p.predict(req, generator=torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        t_req.append(time.perf_counter() - t0)
    check_outputs(outs["checkpoint"], 8, p_ck.modules.flame.n_vertices,
                  n_shape)
    for k in outs["params"]:
        require(np.array_equal(outs["checkpoint"][k], outs["params"][k]),
                f"the converted UNet's {k} differs from params=")
    mods = p_ck.modules
    load_arcface_npz(out / "arcface.npz", mods)
    got = dict(mods.arcface.named_parameters())
    got.update(mods.arcface.named_buffers())
    ref = dict(src.arcface.named_parameters())
    ref.update(src.arcface.named_buffers())
    require(got.keys() == ref.keys() and all(
        torch.equal(got[k].float(), ref[k].float()) for k in ref),
        "load_arcface_npz of the converted backbone")
    mapping = npz_leaves(out / "mapping.npz")
    require(len(mapping) == 2 * src.mapping.n_layers + 2,
            f"mapping.npz leaves {len(mapping)}")
    del src, p_ck, p_par, mods
    print(f"    python -m sr3d_torch.serve -ckt sr_gen.npz (8 faces, "
          f"DDIM-25, int8 default): {t_cli:.2f} s with build, load and "
          f"export; launches {counts}; request of 8 "
          f"{t_req[0] * 1e3:.1f} ms (checkpoint=) / {t_req[1] * 1e3:.1f} "
          f"ms (params=), bit-equal in sr_u8, verts, lmk68, identity; "
          f"arcface.npz loads to the backbone's parameters and statistics; "
          f"{smi}")

    # (b) NoW: the dry run, then a checkpoint on its pictures and scans
    dry = root / "now_dry"
    t0 = time.perf_counter()
    require(now_protocol.main(["-c", str(config), "--out", str(dry),
                               "--subjects", "4", "--imgs", "2",
                               "--batch", "8"]) == 0, "the NoW dry run")
    t_dry = time.perf_counter() - t0
    rep = json.loads((dry / "now_report.json").read_text())
    require(rep["n"] == 8 and np.isfinite(
        [rep["median"], rep["mean"], rep["std"]]).all()
        and len(list((dry / "predicted_meshes").rglob("*.ply"))) == 8,
        f"the dry run's report {rep}")
    with open(config) as f:
        base = yaml.safe_load(f)
    overlay = root / "now_sphere.yml"
    overlay.write_text(yaml.safe_dump(_merge(base, {
        "mica": {"model": {"synthetic_flame_kind": "sphere"}}})))
    pictures, scans = dry / "fixture" / "pictures", dry / "fixture" / "scans"
    ck = root / "now_ckpt"
    t0 = time.perf_counter()
    require(now_protocol.main(["-c", str(overlay), "-ckt", str(trainer_ckpt),
                               "--pictures", str(pictures), "--scans",
                               str(scans), "--out", str(ck),
                               "--batch", "8"]) == 0,
            "the NoW run on the checkpoint")
    t_ck = time.perf_counter() - t0
    rep2 = json.loads((ck / "now_report.json").read_text())
    require(rep2["n"] == 8 and np.isfinite(
        [rep2["median"], rep2["mean"], rep2["std"]]).all(),
        f"the checkpoint run's report {rep2}")
    c2 = update_cfg(get_cfg_defaults(), str(overlay))
    mods = build_joint(c2, init_seed=int(c2.seed), device=dev)
    now_protocol._build_state(c2, str(trainer_ckpt), mods)
    tester = Tester(mods, make_mica_predict(),
                    cache_path=str(ck / "blob_cache.npz"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tester.run(None, pictures, root / "now_timed", batch=8)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep3 = Tester.evaluate_now(root / "now_timed", scans)
    t_eval = time.perf_counter() - t0
    require(abs(rep3["median"] - rep2["median"]) < 1e-6,
            f"the timed run's median {rep3['median']} vs {rep2['median']}")
    st_root = root / "stirling" / "Real_images__Subset_2D_FG2018"
    jpgs = sorted(pictures.rglob("*.jpg"))
    for k, p in enumerate(jpgs):
        q = "HQ" if k < 4 else "LQ"
        (st_root / q).mkdir(parents=True, exist_ok=True)
        shutil.copy(p, st_root / q / f"{'FM'[k % 2]}{1000 + k}_0{k % 2}.jpg")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_counts = tester.run_stirling(None, root / "stirling",
                                    root / "stirling_out", batch=8)
    torch.cuda.synchronize()
    t_st = time.perf_counter() - t0
    require(st_counts == {"HQ": 4, "LQ": 4} and len(list(
        (root / "stirling_out").rglob("*.ply"))) == 8,
        f"Stirling {st_counts}")
    del mods, tester
    print(f"    NoW (python -m sr3d_torch.eval.now_protocol, flagship MICA "
          f"widths): dry run {t_dry:.1f} s (fixture rendered, 8 images, "
          f"median {rep['median']:.3f} mm, random weights); -ckt phase "
          f"10's checkpoint {t_ck:.1f} s, median {rep2['median']:.3f} / "
          f"mean {rep2['mean']:.3f} / std {rep2['std']:.3f} mm; predict + "
          f"export {8 / t_pred:.1f} images/s (cached blobs, batch 8), "
          f"evaluate_now {t_eval:.3f} s (host); Stirling 4 HQ + 4 LQ "
          f"{8 / t_st:.1f} images/s (alignment included); {smi}")

    # (c) dataset tools on faces rendered from the sphere FLAME
    flame = sphere_flame(n_shape=n_shape, n_exp=int(m.n_exp), device=dev)
    rng = np.random.RandomState(9)
    betas = rng.randn(16, n_shape).astype(np.float32)
    views = render_flame_views(
        flame, betas, np.deg2rad(rng.uniform(-20, 20, 16)).astype(np.float32),
        np.deg2rad(rng.uniform(-8, 8, 16)).astype(np.float32),
        np.tile(np.array([[0, 0, 1]], np.float32), (16, 1)), image_size=224)
    u8 = ((views + 1) / 2 * 255).round().astype(np.uint8)
    faces_dir = root / "faces"
    faces_dir.mkdir()
    for i, f in enumerate(u8):
        Image.fromarray(f).save(faces_dir / f"face_{i:02d}.png")
    pre = root / "prepared"
    t0 = time.perf_counter()
    prepare.main(["--path", str(faces_dir), "--out", str(pre), "--size",
                  f"{lo},{hi}", "--srpk", "--n_worker", "0"])
    t_prep = time.perf_counter() - t0
    for ds in (SrpkImageDataset(pre, lo, hi, need_LR=True),
               LRHRDataset(pre, lo, hi, split="val", need_LR=True)):
        batch = next(prefetch_to_device(iter(BatchLoader(
            ds, 8, shuffle=False, num_workers=0)), device=dev))
        for k, shape in (("HR", (8, hi, hi, 3)), ("SR", (8, hi, hi, 3)),
                         ("LR", (8, lo, lo, 3))):
            x = batch[k]
            require(len(ds) == 16 and x.is_cuda and tuple(x.shape) == shape
                    and float(x.min()) >= -1 and float(x.max()) <= 1
                    and float(x.std()) > 0.05,
                    f"prepared {k} ({type(ds).__name__}): "
                    f"{tuple(x.shape)} {x.device}")
    raw = root / "raw" / "FACEWAREHOUSE"
    for a in range(4):
        d = raw / "images" / f"actor{a}"
        d.mkdir(parents=True)
        for i in range(4):
            Image.fromarray(u8[4 * a + i]).save(d / f"{i:02d}.jpg")
        fd = raw / "FLAME_parameters" / f"actor{a}"
        fd.mkdir(parents=True)
        np.savez(fd / "flame.npz", betas=np.concatenate(
            [betas[4 * a], np.zeros(int(m.n_exp), np.float32)]))
    cre = root / "created"
    t0 = time.perf_counter()
    got = creation.main(["--raw-root", str(root / "raw"), "--out-root",
                         str(cre), "--datasets", "FACEWAREHOUSE"])
    t_cre = time.perf_counter() - t0
    require(got == {"FACEWAREHOUSE": 16}, f"creation counts {got}")
    index = np.load(cre / "image_paths" / "FACEWAREHOUSE.npy",
                    allow_pickle=True).item()
    for actor, (imgs, _) in index.items():
        d = cre / "FACEWAREHOUSE" / "SR" / f"{lo}_{hi}" / actor
        d.mkdir(parents=True)
        for rel in imgs:
            hr = Image.open(cre / rel).resize((hi, hi), Image.BICUBIC)
            lr = hr.resize((lo, lo), Image.BICUBIC)
            stem = Path(rel).stem
            hr.save(d / f"{stem}_hr.png")
            lr.save(d / f"{stem}_lr.png")
            lr.resize((hi, hi), Image.BICUBIC).save(d / f"{stem}_sr.png")
    jds = JointFaceDataset(cre, "FACEWAREHOUSE", K=2, lr_res=lo, hr_res=hi,
                           n_shape=n_shape, n_exp=int(m.n_exp))
    jb = next(prefetch_to_device(iter(BatchLoader(
        jds, 2, shuffle=False, num_workers=0)), device=dev))
    for k, shape in (("arcface", (2, 2, 112, 112, 3)),
                     ("image", (2, 2, 224, 224, 3)),
                     ("HR", (2, 2, hi, hi, 3)), ("LR", (2, 2, lo, lo, 3)),
                     ("flame_shape", (2, 2, n_shape))):
        x = jb[k]
        require(x.is_cuda and tuple(x.shape) == shape
                and float(x.min()) >= (-1 if k != "flame_shape" else -10)
                and float(x.max()) <= (1 if k != "flame_shape" else 10),
                f"joint {k}: {tuple(x.shape)} {x.device}")
    want_shape = torch.from_numpy(np.stack([betas[0], betas[4]])).to(dev)
    require(torch.equal(jb["flame_shape"][:, 0], want_shape),
            "the joint batch's FLAME shapes are the raw tree's")
    print(f"    prepare --srpk ({lo},{hi}) on 16 rendered 224^2 faces: {t_prep:.2f} s = "
          f"{16 / t_prep:.1f} images/s (serial); creation --raw-root, 4 "
          f"actors x 4: {t_cre:.2f} s = {16 / t_cre:.1f} images/s "
          f"(center-crop alignment, no insightface); batches of the packed "
          f"stores, the PNG dirs and the joint dataset onto the card through "
          f"prefetch_to_device, shapes and ranges checked; {smi}")
    shutil.rmtree(root)
    print(f"    phase 12 in {time.perf_counter() - t_phase:.1f} s; {smi}")
    return counts


# ---------------------------------------------------------------------------
# 3 (cont.): the kernels at every repo config's shapes and at the spatial
# bands of the flagship
# ---------------------------------------------------------------------------

def trace_config(path: Path, B: int, quant: bool) -> dict:
    """The GN+Swish inputs (B, C, H, W, groups), attention inputs (B, HW,
    C) and int8 convs (B, Cin, H, W, O, stride, scale) of one forward of the UNet
    of the config at ``path`` at its output resolution, batch ``B``
    (``quant``: the serving CLI's int8 default): a meta-device trace."""
    import sr3d_torch.models.sr3_unet as unet_mod
    import sr3d_torch.ops.quant as quant_mod
    from sr3d_torch.config import get_cfg_defaults, update_cfg

    cfg = update_cfg(get_cfg_defaults(), str(path))
    if quant:
        cfg.sr.model.unet.quant_min_res = 1
        cfg.sr.model.unet.quant_resample = True
    hr = int(cfg.sr.datasets.val.r_resolution)
    seen = {"gn": set(), "attn": set(), "int8": set()}

    def gn(x, gamma, beta, groups, eps=1e-5):
        seen["gn"].add((*x.shape, groups))
        return x

    def attn(q, k, v, channels=None):
        seen["attn"].add(tuple(q.shape))
        return q

    def int8(x, wk, w_scale, bias=None, *, stride=1, padding=1,
             out_dtype=None, a_scale=None):
        Bx, C, H, W = x.shape
        seen["int8"].add((Bx, C, H, W, wk.shape[0], stride,
                          "dynamic" if a_scale is None else "static"))
        return x.new_empty(Bx, wk.shape[0], (H - 1) // stride + 1,
                           (W - 1) // stride + 1)

    saved = (unet_mod.gn_swish, unet_mod.spatial_attention,
             quant_mod.int8_conv_quantized)
    unet_mod.gn_swish, unet_mod.spatial_attention = gn, attn
    quant_mod.int8_conv_quantized = int8
    try:
        with torch.device("meta"), torch.no_grad():
            unet = unet_mod.unet_from_config(cfg.sr.model.unet,
                                             cfg.sr.model.diffusion)
            unet(torch.zeros(B, int(cfg.sr.model.unet.in_channel), hr, hr),
                 torch.zeros(B, 1), quant=quant)
    finally:
        (unet_mod.gn_swish, unet_mod.spatial_attention,
         quant_mod.int8_conv_quantized) = saved
    return seen


def phase_config_shapes(dev) -> dict:
    """GN+Swish, attention and the int8 conv against their plain versions
    at the shapes of every ``configs/*.yml`` UNet not checked above (B = 8,
    4, 2, 1; int8 at B = 8 and 1), among them H·W of 1 and 4 and attention
    at 16 and 1 tokens; then the spatial path's bands of the flagship over
    2 and 4 ranks, emulated in one process: GN+Swish as ``gn_stats`` of
    each band, the moments summed, the apply kernel over each band with
    the whole image's count (against ``gn_swish_reference`` of the whole
    image), and the int8 convs on a band with its halo rows.  bf16, checks
    only (no timing).  Returns {kernel: [shapes checked]}."""
    from sr3d_torch.kernels import gn_stats, gn_swish, spatial_attention
    from sr3d_torch.kernels.attention import spatial_attention_reference
    from sr3d_torch.kernels.groupnorm_swish import (gn_swish_apply,
                                                    gn_swish_reference)
    from sr3d_torch.kernels.int8_conv import (int8_conv_quantized,
                                              int8_conv_reference,
                                              prepare_weight)

    dtype = torch.bfloat16
    configs = sorted((ROOT / "configs").glob("*.yml"))
    gn_all, attn_all, int8_all = set(), set(), set()
    for path in configs:
        for B in MAIN_PATH_BATCHES:
            s = trace_config(path, B, quant=False)
            gn_all |= s["gn"]
            attn_all |= s["attn"]
        for B in (8, 1):
            int8_all |= trace_config(path, B, quant=True)["int8"]
    done_gn = {(*s, 32) for s in set(main_path_gn_shapes()) | set(GN_SHAPES)}
    done_int8 = set(main_path_int8_convs())
    new_gn = sorted(gn_all - done_gn, key=lambda s: -math.prod(s[:4]))
    new_attn = sorted(attn_all - set(ATTN_SHAPES))
    new_int8 = sorted(int8_all - done_int8, key=lambda s: -math.prod(s[:5]))
    atol, rtol = GN_TOL[dtype]
    worst = {"gn_swish": 0.0, "spatial_attention": 0.0, "int8_conv": 0.0,
             "gn_band": 0.0}
    for (*shape, G) in new_gn:
        g = torch.Generator(device=dev).manual_seed(7)
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
        gamma = torch.rand(shape[1], generator=g, device=dev) + 0.5
        beta = torch.randn(shape[1], generator=g, device=dev) * 0.1
        y, ref = gn_swish(x, gamma, beta, G), gn_swish_reference(
            x, gamma, beta, G)
        e = float((y.float() - ref.float()).abs().max())
        require(torch.allclose(y.float(), ref.float(), atol=atol, rtol=rtol),
                f"gn_swish disagrees at config shape {shape} G={G}: {e}")
        worst["gn_swish"] = max(worst["gn_swish"], e)
    for (B, HW, C) in new_attn:
        g = torch.Generator(device=dev).manual_seed(8)
        q, k, v = (torch.randn(B, HW, C, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        out = spatial_attention(q, k, v)
        ref = spatial_attention_reference(q, k, v, C ** -0.5)
        e = float((out.float() - ref.float()).abs().max())
        require(torch.allclose(out.float(), ref.float(), atol=atol,
                               rtol=rtol),
                f"attention disagrees at config shape {(B, HW, C)}: {e}")
        worst["spatial_attention"] = max(worst["spatial_attention"], e)

    def int8_check(B, C, H, W, O, stride, scale, what):
        g = torch.Generator(device=dev).manual_seed(9)
        w = torch.randn(O, C, 3, 3, generator=g, device=dev) * (9 * C) ** -.5
        x = (torch.randn(B, C, H, W, generator=g, device=dev) * 2).to(dtype)
        b = torch.randn(O, generator=g, device=dev) * 0.1
        a = torch.tensor(0.05, device=dev) if scale == "static" else None
        out = int8_conv_quantized(x, *prepare_weight(w), b, stride=stride,
                                  out_dtype=dtype, a_scale=a)
        ref = int8_conv_reference(x, w, b, stride=stride, out_dtype=dtype,
                                  a_scale=a)
        e = float((out.float() - ref.float()).abs().max())
        require(torch.equal(out, ref), f"int8_conv differs from its plain "
                f"version at {what} {(B, C, H, W)}->{O} stride {stride}: "
                f"{e}")
        worst["int8_conv"] = max(worst["int8_conv"], e)

    for (B, C, H, W, O, stride, scale) in new_int8:
        int8_check(B, C, H, W, O, stride, scale, "config shape")
    # the spatial bands of the flagship: GN over bands of 2 and 4 ranks at
    # the spatial request's batch (2), the int8 convs on a band + its halo
    bands_gn, bands_int8 = [], set()
    for m in (2, 4):
        for (B, C, H, W, G) in sorted(trace_config(CONFIG, 2,
                                                   False)["gn"]):
            g = torch.Generator(device=dev).manual_seed(10)
            x = (torch.randn(B, C, H, W, generator=g, device=dev) * 2
                 + 0.5).to(dtype)
            x[:, :, H // 2:] += 1.0   # bands whose means differ
            gamma = torch.rand(C, generator=g, device=dev) + 0.5
            beta = torch.randn(C, generator=g, device=dev) * 0.1
            parts = x.chunk(m, dim=2)
            stats = [gn_stats(p.contiguous()) for p in parts]
            s = sum(t[0] for t in stats)
            q = sum(t[1] for t in stats)
            y = torch.cat([gn_swish_apply(p.contiguous(), s, q, gamma, beta,
                                          G, count=H * W) for p in parts], 2)
            ref = gn_swish_reference(x, gamma, beta, G)
            e = float((y.float() - ref.float()).abs().max())
            require(torch.allclose(y.float(), ref.float(), atol=atol,
                                   rtol=rtol),
                    f"band GN over {m} ranks disagrees at {(B, C, H, W)}: "
                    f"{e}")
            worst["gn_band"] = max(worst["gn_band"], e)
            bands_gn.append((m, B, C, H // m, W))
        for (B, C, H, W, O, stride, scale) in trace_config(CONFIG, 2,
                                                           True)["int8"]:
            ext = H // m + 2    # the band and its halo rows (stride 2: a
            bands_int8.add((B, C, ext, W, O, stride, scale))  # zero, one)
    for c in sorted(bands_int8):
        int8_check(*c, "band + halo")
    print(f"  every repo config ({len(configs)} YAMLs, B = "
          f"{', '.join(map(str, MAIN_PATH_BATCHES))}): {len(new_gn)} more "
          f"GN+Swish shapes (H*W down to "
          f"{min(s[2] * s[3] for s in new_gn) if new_gn else '-'}; groups "
          f"{sorted({s[4] for s in new_gn})}), "
          f"{len(new_attn)} attention shapes (tokens "
          f"{sorted({s[1] for s in new_attn})}), {len(new_int8)} int8 convs "
          f"checked; max err gn_swish {worst['gn_swish']:.3g}, attention "
          f"{worst['spatial_attention']:.3g} (atol {atol}, rtol {rtol}), "
          f"int8_conv bit for bit")
    print(f"  the flagship's spatial bands (2 and 4 ranks, B = 2): "
          f"{len(bands_gn)} band GNs (gn_stats per band, moments summed, "
          f"the apply kernel with the whole image's count) vs "
          f"gn_swish_reference of the whole image, max err "
          f"{worst['gn_band']:.3g}; {len(bands_int8)} int8 convs on a band "
          f"+ halo, bit for bit")
    return {"gn_swish": [list(s) for s in new_gn],
            "spatial_attention": [list(s) for s in new_attn],
            "int8_conv": [list(s[:6]) for s in new_int8],
            "gn_band": [list(s) for s in bands_gn],
            "int8_band": [list(s[:6]) for s in sorted(bands_int8)],
            "max_abs_err": worst}


# ---------------------------------------------------------------------------
# 13. the parallel layer: several ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

PAR_WORLD = 2
# sharded against one process on the same weights and draws, bf16 on the
# card: a band's or a half batch's convolutions round unlike the whole
# one's, and the sampler carries that through its 25 steps, int8 more so
# (a rounding difference moves an activation across a quantization step).
# Each limit sits between the sound run's reading and its per-rank
# control's where the control shows (readings of this script on the
# H100 80GB HBM3, 700 W, equal in every run): one UNet forward, max
# error of the output's largest entry (bf16 0.0108; int8 0.0027 against
# 0.147 with the int8 scale per rank); the
# request's uint8 image by a mean of levels (bf16 1.127 DP, 1.120 spatial
# against 3.718 with GroupNorm per band; int8 4.948, and 5.022 with the
# scale per rank: the request cannot see that, the forward can), the
# vertices and the shape code by an absolute error
PAR_FORWARD_TOL = {"bf16": 5e-2, "int8": 2e-2}
PAR_SERVE_TOL = {"bf16": {"u8_mean": 2.0, "verts": 5e-3, "identity": 2e-2},
                 "int8": {"u8_mean": 6.0, "verts": 5e-3, "identity": 2e-2}}
# the losses of sharded steps against one rank's (DP 3.3e-4, TP 1.1e-4;
# a run without gradient averaging 2.2e-4: the losses cannot see it after
# one update, the checkpoint can)
PAR_TRAIN_RTOL = 1e-3
# a checkpoint of a sharded run against one process's, leaf for leaf: the
# integer leaves equal; at most PAR_CKPT_OFF of the float elements
# further than PAR_CKPT_REL of their leaf's largest entry, and none
# further than PAR_CKPT_WORST × (2·lr·steps + PAR_CKPT_REL × that entry)
# (2·lr·steps: Adam's reach in the run's updates, where an element whose
# gradient is rounding noise moves ~lr either way).  bf16 gradients at a
# half batch round unlike the whole one's, so the CPU tests' 1e-5 and 1
# do not hold here: the sound DP / TP runs read 0.0249 / 0.0284 off and
# 58 / 66 worst, the controls (no gradient averaging; the split weights
# gathered in reverse order) 0.127 / 0.729 and 253 / 154
PAR_CKPT_REL = 1e-2
PAR_CKPT_OFF = 0.06
PAR_CKPT_WORST = 120
# the relative gaps at which the share of elements off is also printed
PAR_CKPT_GRID = (1e-4, 1e-3, 1e-2)


def _par_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_rank(rank: int, world: int, port: int, spec_path: str) -> None:
    """One rank of phase 13: its own process on the shared card, the
    ``gloo`` group, then the jobs of ``spec_path`` in turn; each job's
    results (and this rank's launches, seconds and peak memory) saved
    beside it."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    watch_plain_gn()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = {}
        for job in spec["jobs"]:
            out[job] = PAR_JOBS[job](spec, dev)
            dist.barrier()
        torch.save(out, Path(spec["dir"]) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _par_measure(dev, fn):
    """``fn()`` with the launch counters at 0 before and read after: its
    value, wall seconds, launches and peak device memory (GiB)."""
    from sr3d_torch.kernels import launch_counts, reset_launch_counts

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    value = fn()
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)
    return value, dt, counts, peak


def _par_serve(spec, dev, spatial: bool, int8: bool, n: int):
    from sr3d_torch import parallel as par
    from sr3d_torch.models.flame import synthetic_flame
    from sr3d_torch.serve import Predictor, apply_serving_flags

    cfg = spec["serve_cfg"].clone()
    if int8:
        apply_serving_flags(cfg)
    flame = synthetic_flame(**spec["flame_kw"], device=dev)
    mesh = par.make_mesh((1, PAR_WORLD) if spatial else (PAR_WORLD, 1))
    p = Predictor.from_config(cfg, init_seed=0, batch_size=n, flame=flame,
                              device=dev, mesh=mesh, spatial=spatial)
    p.predict(spec["req"][:n])     # warm up (cuDNN plans, weight casts)
    return _par_measure(dev, lambda: p.predict(spec["req"][:n])) + (p,)


def _par_collectives(dev) -> dict:
    """The port's collectives on this device over the gloo group, on
    values whose results are known: a sum and a max all-reduce, an
    all-gather, and the gradients of the all-gather and the sum."""
    import torch.distributed as dist

    from sr3d_torch import parallel as par
    from sr3d_torch.parallel.collectives import (all_gather, all_reduce_max,
                                                 all_reduce_sum)

    axis = par.make_mesh((PAR_WORLD, 1)).axis("data")
    r, n = dist.get_rank(), PAR_WORLD
    x = torch.full((3,), float(r + 1), device=dev, requires_grad=True)
    s = all_reduce_sum(x, axis)
    g = all_gather(x[None], 0, axis)
    (s.sum() + (g * torch.arange(n, device=dev)[:, None]).sum()).backward()
    want_grad = n + n * r      # the sum's, and the gather's weight summed
    return {"sum": bool((s == n * (n + 1) / 2).all()),
            "max": float(all_reduce_max(torch.tensor(float(r), device=dev),
                                        axis)) == n - 1,
            "gather": bool((g[:, 0] == torch.arange(1, n + 1, device=dev))
                           .all()),
            "grad": bool((x.grad == want_grad).all())}


def _par_unet_forward(spec, dev, p, quant: bool) -> torch.Tensor:
    """One UNet forward of the Predictor's weights on the seeded global
    input ``par_unet_input``, this rank's rows, gathered."""
    from sr3d_torch import parallel as par
    from sr3d_torch.parallel import layout as lay

    x, t = par_unet_input(spec["req"].shape[0], p.hr, dev)
    with lay.use(par.data_layout(par.make_mesh((PAR_WORLD, 1)))), \
            torch.no_grad():
        return lay.gather(p.modules.unet(lay.local(x), lay.local(t),
                                         quant=quant)).float().cpu()


def par_unet_input(n: int, hr: int, dev):
    """A seeded UNet input whose second half of rows is 16× the first's, so
    that the ranks' parts differ in their largest entry (the int8
    scale)."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, 6, hr, hr, generator=g, device=dev)
    x[n // 2:] *= 16
    return x, torch.full((n, 1), 0.5, device=dev)


def _par_job_dp_serve(spec, dev):
    """(a) the collectives on the card; the flagship's DDIM-25 request (8
    faces, batch 8) over the ranks' rows, bf16 and int8, and one UNet
    forward of each on a fixed input."""
    out = {"collectives": _par_collectives(dev)}
    for tag in ("bf16", "int8", "int8_per_rank"):
        # the control: each rank's activations quantized with its own
        # part's scale
        with _control(tag == "int8_per_rank",
                      "sr3d_torch.parallel.layout.amax", lambda x: x):
            res = _par_serve(spec, dev, False, tag != "bf16",
                             len(spec["req"]))
            out[tag] = res[:4] + (_par_unet_forward(spec, dev, res[4],
                                                    tag != "bf16"),)
    return out


def _control(on: bool, target: str, value):
    """A per-rank control: ``target`` (a module attribute) replaced by
    ``value`` for the block where ``on``."""
    from unittest import mock

    return mock.patch(target, value) if on else contextlib.nullcontext()


def _par_job_spatial_serve(spec, dev):
    """(b) the band GN at every GN shape of the spatial path, then a
    request of 2 with the image's 128 rows split over 2 ranks."""
    from sr3d_torch import parallel as par
    from sr3d_torch.kernels.groupnorm_swish import gn_swish_reference
    from sr3d_torch.models.sr3_unet import GroupNormSwish
    from sr3d_torch.parallel import layout as lay

    mesh = par.make_mesh((1, PAR_WORLD))
    G = int(spec["serve_cfg"].sr.model.unet.norm_groups)
    errs = {}
    with lay.use(par.spatial_layout(mesh)), torch.no_grad():
        for (B, C, H, W) in spec["spatial_gn_shapes"]:
            g = torch.Generator(device=dev).manual_seed(11)
            x = (torch.randn(B, C, H, W, generator=g, device=dev) * 2
                 + 0.5).to(torch.bfloat16)
            x[:, :, H // 2:] += 1.0
            m = GroupNormSwish(C, G).to(dev)
            m.scale.data = torch.rand(C, generator=g, device=dev) + 0.5
            m.bias.data = torch.randn(C, generator=g, device=dev) * 0.1
            y = lay.gather(m(lay.local(x, row_dim=2)), row_dim=2)
            ref = gn_swish_reference(x, m.scale, m.bias, G)
            atol, rtol = GN_TOL[torch.bfloat16]
            errs[(B, C, H, W)] = (
                float((y.float() - ref.float()).abs().max()),
                torch.allclose(y.float(), ref.float(), atol=atol, rtol=rtol))
    out = {"gn_errs": errs,
           "bf16": _par_serve(spec, dev, True, False, 2)[:4]}
    # the control: GroupNorm's moments over the band alone (the band's
    # sums scaled to the image's count)
    with _control(True, "sr3d_torch.models.sr3_unet.all_reduce_sum",
                  lambda t, axis: t * axis.size):
        out["per_band"] = _par_serve(spec, dev, True, False, 2)[:4]
    return out


def _par_cli(spec, dev, name: str, steps: int):
    from sr3d_torch.cli.main import main as cli_main

    argv = ["-p", "train", "-c", spec["overlays"][name], "--max-steps",
            str(steps)]
    plain0 = PLAIN_GN["calls"]
    _, dt, counts, peak = _par_measure(dev, lambda: cli_main(argv,
                                                             device=dev))
    # the calls of GN+Swish's plain version on the card during the call
    return PLAIN_GN["calls"] - plain0, dt, counts, peak


def _par_job_trainer_dp(spec, dev):
    """(c) the joint Trainer through the CLI at mesh [2, 1], 3 steps."""
    return _par_cli(spec, dev, "dp", 3)


def _par_job_trainer_dp_control(spec, dev):
    """The control of (c): mesh [2, 1] with each rank stepping on its own
    rows' gradient (no averaging over the data axis), 2 steps."""
    with _control(True, "sr3d_torch.train.joint.average_gradients",
                  lambda params: None):
        return _par_cli(spec, dev, "dp_control", 2)


def _par_job_trainer_tp(spec, dev):
    """(d) the joint Trainer through the CLI at mesh [1, 2], tp_min_channels
    128, 2 steps."""
    return _par_cli(spec, dev, "tp", 2)


PAR_JOBS = {"dp_serve": _par_job_dp_serve,
            "spatial_serve": _par_job_spatial_serve,
            "trainer_dp": _par_job_trainer_dp,
            "trainer_dp_control": _par_job_trainer_dp_control,
            "trainer_tp": _par_job_trainer_tp}


def par_spawn(spec: dict, tmp: Path) -> list[dict]:
    """Run ``spec["jobs"]`` on ``PAR_WORLD`` ranks; every rank's exit code
    is checked and a failed rank's error text raised; returns each rank's
    results."""
    import torch.multiprocessing as mp

    spec = dict(spec, dir=str(tmp))
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    ctx = mp.start_processes(_par_rank, args=(PAR_WORLD, _par_free_port(),
                                              str(spec_path)),
                             nprocs=PAR_WORLD, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(PAR_WORLD)]


def _losses(run: Path) -> list[float]:
    rows = [json.loads(x) for x in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == "train/loss"]


def _ckpt_gap(mine: list, theirs: list, steps: int, lr: float,
              rels=PAR_CKPT_GRID) -> dict:
    """A checkpoint's leaves against one process's, by the rule of
    ``PAR_CKPT_REL``: for each relative gap ``rel`` in ``rels``, (the
    share of float elements further than ``rel`` of their leaf's largest
    entry, the largest max|a − b| / (2·lr·steps + rel·max|b|) of a float
    leaf, which ``PAR_CKPT_WORST`` bounds);
    ``"ints"``: the integer leaves equal; ``"widest"``: (leaf, shape,
    max|b|, max|a − b|) of the leaf with the largest gap of its scale."""
    off = dict.fromkeys(rels, 0)
    worst = dict.fromkeys(rels, 0.0)
    total, ints, widest, ratio = 0, True, (None, None, 0.0, 0.0), -1.0
    for i, (a, b) in enumerate(zip(mine, theirs)):
        if a.dtype.kind != "f":
            ints &= a.shape == b.shape and bool(np.array_equal(a, b))
            continue
        d = np.abs(a - b)
        scale, dmax = float(np.abs(b).max()), float(d.max())
        if dmax / max(scale, 1e-30) > ratio:
            widest, ratio = (i, a.shape, scale, dmax), dmax / max(scale, 1e-30)
        for rel in rels:
            worst[rel] = max(worst[rel], dmax / (2 * lr * steps
                                                 + rel * scale))
            off[rel] += int((d > rel * scale + 1e-12).sum())
        total += d.size
    return {"share": {r: off[r] / max(total, 1) for r in rels},
            "worst": worst, "ints": ints, "widest": widest}


def _ckpt_ok(gap: dict) -> bool:
    return (gap["ints"] and gap["share"][PAR_CKPT_REL] <= PAR_CKPT_OFF
            and gap["worst"][PAR_CKPT_REL] <= PAR_CKPT_WORST)


def _ckpt_text(gap: dict) -> str:
    i, shape, scale, dmax = gap["widest"]
    return ("share off at rel " + ", ".join(
        f"{r:g}: {v:.3g}" for r, v in gap["share"].items())
        + "; worst leaf gap / (2·lr·steps + rel·scale) at rel "
        + ", ".join(f"{r:g}: {v:.3g}" for r, v in gap["worst"].items())
        + f"; widest gap: leaf {i} {tuple(shape) if shape else ''}, "
        f"largest entry {scale:.3g}, gap {dmax:.3g}")


def _swapped(leaves: list, min_channels: int) -> list:
    """A file's leaves as a wrong gather would write them: the ranks'
    parts of every split weight (and moment) in reverse order, i.e. the
    last dim (output channels in the JAX layout) of every float leaf of
    ≥ 2 dims at least ``min_channels`` wide cut in ``PAR_WORLD`` and
    reversed."""
    return [np.concatenate(np.split(a, PAR_WORLD, -1)[::-1], -1)
            if a.dtype.kind == "f" and a.ndim >= 2
            and a.shape[-1] >= min_channels and a.shape[-1] % PAR_WORLD == 0
            else a for a in leaves]


def _u8_err(a: np.ndarray, b: np.ndarray) -> tuple[float, int]:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float(d.mean()), int(d.max())


def phase_parallel(dev, flame_kw: dict, tmp: Path, overlay: Path,
                   config: Path = CONFIG, n_req: int = 8) -> dict:
    """Phase 13: the parallel layer with ``PAR_WORLD`` ranks sharing the
    one card over ``gloo`` (NCCL takes one card a rank): (a) DP serving,
    (b) spatial serving, (c) the Trainer at mesh [2, 1], (d) at [1, 2]
    (tensor parallel), each against one process on the same weights,
    draws and data.  Returns the launches of each path (summed over the
    ranks)."""
    import yaml

    from sr3d_torch.cli.main import main as cli_main
    from sr3d_torch.models.flame import synthetic_flame
    from sr3d_torch.serve import Predictor, apply_serving_flags
    from sr3d_torch.train.checkpoint import load_train_state, npz_leaves
    from sr3d_torch.train.joint import build_joint, init_train_state

    label = f"{PAR_WORLD} ranks sharing one H100 over gloo"
    print(f"[13] parallel: {label} (NCCL takes one card a rank; these "
          f"times measure the layer's overhead, not scaling)")
    cfg = serving_cfg("ddim")
    if config != CONFIG:
        from sr3d_torch.config import get_cfg_defaults, update_cfg
        cfg = update_cfg(get_cfg_defaults(), str(config))
    req = np.random.RandomState(5).randint(0, 256, (n_req, 16, 16, 3),
                                           np.uint8)
    req = req[:, :int(cfg.sr.datasets.val.l_resolution),
              :int(cfg.sr.datasets.val.l_resolution)]
    flame = synthetic_flame(**flame_kw, device=dev)

    # one-process references: the same weights (init_seed 0) and draws
    refs, ref_fwd = {}, {}
    for tag, n, int8 in (("bf16", n_req, False), ("int8", n_req, True),
                         ("spatial", 2, False)):
        c = apply_serving_flags(cfg.clone()) if int8 else cfg
        p = Predictor.from_config(c, init_seed=0, batch_size=n, flame=flame,
                                  device=dev)
        p.predict(req[:n])
        refs[tag] = p.predict(req[:n])
        if tag != "spatial":
            with torch.no_grad():
                ref_fwd[tag] = p.modules.unet(
                    *par_unet_input(n, p.hr, dev), quant=int8).float().cpu()
        del p
    spatial_gn = sorted(s[:4] for s in trace_config(config, 2, False)["gn"])

    # the Trainer's runs: one process (3 steps, checkpoints at 2 and 3),
    # then the ranks' DP (3 steps) and TP (2 steps) runs, final checkpoints
    base = yaml.safe_load(overlay.read_text())
    overlays = {}
    for name, mesh, ckpt_every in (("one", [1, 1], 2), ("dp", [2, 1], 0),
                                   ("dp_control", [2, 1], 0),
                                   ("tp", [1, 2], 0)):
        tree = _merge(json.loads(json.dumps(base)), {
            "name": f"par_{name}", "output_dir": str(tmp / "out"),
            "mica": {"train": {"eval_steps": 0}},
            "train": {"checkpoint_steps": ckpt_every, "eval_steps": 0,
                      "vis_steps": 0, "log_steps": 1,
                      "checkpoint_max_keep": 10},
            "tpu": {"mesh_shape": mesh, "tp_min_channels": 128}})
        overlays[name] = str(tmp / f"par_{name}.yml")
        Path(overlays[name]).write_text(yaml.safe_dump(tree))
    _, t_one, _, _ = _par_measure(dev, lambda: cli_main(
        ["-p", "train", "-c", overlays["one"], "--max-steps", "3"],
        device=dev))
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    spec = {"device": str(dev), "serve_cfg": cfg, "flame_kw": flame_kw,
            "req": req, "spatial_gn_shapes": spatial_gn,
            "overlays": overlays,
            "jobs": ["dp_serve", "spatial_serve", "trainer_dp",
                     "trainer_dp_control", "trainer_tp"]}
    t0 = time.perf_counter()
    ranks = par_spawn(spec, tmp)
    t_ranks = time.perf_counter() - t0
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a) DP serving
    coll = [res["dp_serve"]["collectives"] for res in ranks]
    require(all(all(c.values()) for c in coll),
            f"(a) the collectives over gloo on {dev}: {coll}")
    print(f"    (a) collectives on {dev} tensors over gloo (sum, max, "
          f"all-gather and their gradients): right on every rank")
    for tag in ("bf16", "int8"):
        errs = []
        for r, res in enumerate(ranks):
            out, dt, c, peak, fwd = res["dp_serve"][tag]
            e_fwd = float((fwd - ref_fwd[tag]).abs().max()
                          / ref_fwd[tag].abs().max())
            require(e_fwd <= PAR_FORWARD_TOL[tag],
                    f"(a) one {tag} UNet forward over the ranks' rows vs "
                    f"one process: max err {e_fwd:.3g} of the output's "
                    f"scale, tolerance {PAR_FORWARD_TOL[tag]}")
            if dev.type == "cuda":
                check_outputs(out, n_req, flame.n_vertices,
                              int(cfg.mica.model.n_shape))
            u8 = _u8_err(out["sr_u8"], refs[tag]["sr_u8"])
            ev = float(np.abs(out["verts"] - refs[tag]["verts"]).max())
            ei = float(np.abs(out["identity"] - refs[tag]["identity"]).max())
            tol = PAR_SERVE_TOL[tag]
            require(u8[0] <= tol["u8_mean"] and ev <= tol["verts"]
                    and ei <= tol["identity"],
                    f"(a) DP {tag} rank {r} vs one process: uint8 mean/max "
                    f"{u8}, verts {ev}, identity {ei}; tolerance {tol}")
            add(c)
            errs.append(f"rank {r}: {dt * 1e3:.1f} ms, peak {peak:.2f} GiB,"
                        f" launches {c}")
        want_int8 = tag == "int8"
        require((ranks[0]["dp_serve"][tag][2]["int8_conv"] > 0) == want_int8
                and ranks[0]["dp_serve"][tag][2]["gn_swish"] > 0,
                f"(a) {tag} launches {ranks[0]['dp_serve'][tag][2]}")
        print(f"    (a) DP serving {tag}, DDIM-25, request of {n_req} over "
              f"{PAR_WORLD} ranks' rows ({label}): one UNet forward vs one "
              f"process {e_fwd:.3g} of its scale (tolerance "
              f"{PAR_FORWARD_TOL[tag]}); the request vs one process uint8 "
              f"mean/max {u8[0]:.3f}/{u8[1]}, verts {ev:.3g}, identity "
              f"{ei:.3g} (tolerance {PAR_SERVE_TOL[tag]}); "
              + "; ".join(errs))
    # the control: each rank's own int8 scale
    ctl = []
    for res in ranks:
        out, _, _, _, fwd = res["dp_serve"]["int8_per_rank"]
        ctl.append((float((fwd - ref_fwd["int8"]).abs().max()
                          / ref_fwd["int8"].abs().max()),
                    _u8_err(out["sr_u8"], refs["int8"]["sr_u8"])[0]))
    c_fwd, c_u8 = max(c[0] for c in ctl), max(c[1] for c in ctl)
    require(c_fwd > PAR_FORWARD_TOL["int8"],
            f"(a) control: with the int8 scale per rank one UNet forward "
            f"is {c_fwd:.3g} of its scale from one process, within the "
            f"tolerance {PAR_FORWARD_TOL['int8']}: the check cannot see it")
    print(f"    (a) control, the int8 scale per rank: one UNet forward vs "
          f"one process {c_fwd:.3g} of its scale (must exceed "
          f"{PAR_FORWARD_TOL['int8']}); the request's uint8 mean "
          f"{c_u8:.3f} (tolerance {PAR_SERVE_TOL['int8']['u8_mean']})")

    # (b) spatial serving
    gn = [v for res in ranks for v in res["spatial_serve"]["gn_errs"]
          .values()]
    gn_err = max(e for e, _ in gn)
    require(all(ok for _, ok in gn), f"(b) band GN disagrees with "
            f"gn_swish_reference: max err {gn_err} (GN_TOL bf16)")
    lines = []
    for r, res in enumerate(ranks):
        out, dt, c, peak = res["spatial_serve"]["bf16"]
        u8 = _u8_err(out["sr_u8"], refs["spatial"]["sr_u8"])
        ev = float(np.abs(out["verts"] - refs["spatial"]["verts"]).max())
        ei = float(np.abs(out["identity"]
                          - refs["spatial"]["identity"]).max())
        tol = PAR_SERVE_TOL["bf16"]
        require(u8[0] <= tol["u8_mean"] and ev <= tol["verts"]
                and ei <= tol["identity"],
                f"(b) spatial rank {r} vs one process: uint8 mean/max {u8}, "
                f"verts {ev}, identity {ei}; tolerance {tol}")
        require(c["gn_stats"] > 0 and c["gn_swish"] > 0
                and c["spatial_attention"] > 0,
                f"(b) spatial launches {c}")
        add(c)
        lines.append(f"rank {r}: {dt * 1e3:.1f} ms, peak {peak:.2f} GiB, "
                     f"launches {c}")
    print(f"    (b) spatial serving bf16, request of 2, 128 rows split "
          f"{128 // PAR_WORLD} x {PAR_WORLD} ({label}): band GN (gn_stats, "
          f"all-reduce, apply kernel) vs gn_swish_reference of the whole "
          f"image at {len(spatial_gn)} GN shapes, max err {gn_err:.3g}; vs "
          f"one process uint8 mean/max {u8[0]:.3f}/{u8[1]}, verts "
          f"{ev:.3g}, identity {ei:.3g}; " + "; ".join(lines))
    # the control: GroupNorm's moments over each band alone
    c_u8 = max(_u8_err(res["spatial_serve"]["per_band"][0]["sr_u8"],
                       refs["spatial"]["sr_u8"])[0] for res in ranks)
    require(c_u8 > PAR_SERVE_TOL["bf16"]["u8_mean"],
            f"(b) control: with GroupNorm per band the request is "
            f"{c_u8:.3f} uint8 levels from one process, within the "
            f"tolerance {PAR_SERVE_TOL['bf16']['u8_mean']}")
    print(f"    (b) control, GroupNorm's moments per band: uint8 mean "
          f"{c_u8:.3f} from one process (must exceed "
          f"{PAR_SERVE_TOL['bf16']['u8_mean']})")

    # (c), (d) the Trainer
    one = tmp / "out" / "par_one"
    ref_losses = _losses(one)
    require(len(ref_losses) == 3, f"one-process losses {ref_losses}")
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    tcfg = update_cfg(get_cfg_defaults(), overlays["one"])
    lr = max(float(tcfg.sr.train.optimizer.lr), float(tcfg.mica.train.lr),
             float(tcfg.mica.train.arcface_lr))

    def loss_gap(got: list) -> float:
        return max(abs(a - b) / abs(b) for a, b in zip(got, ref_losses))

    def ckpt(tag: str, steps: int) -> list:
        run = tmp / "out" / f"par_{tag}"
        ckpts = sorted(p.name for p in (run / "checkpoint").glob("*.npz"))
        require(ckpts == [f"ckpt_{steps:010d}.npz"], f"{tag} ckpts {ckpts}")
        return npz_leaves(run / "checkpoint" / ckpts[0])

    for tag, steps in (("dp", 3), ("tp", 2)):
        c_ = "c" if tag == "dp" else "d"
        got = _losses(tmp / "out" / f"par_{tag}")
        require(len(got) == steps and loss_gap(got) <= PAR_TRAIN_RTOL,
                f"({c_}) {tag} losses {got} vs one process "
                f"{ref_losses[:steps]} (rtol {PAR_TRAIN_RTOL})")
        mine = ckpt(tag, steps)
        theirs = npz_leaves(one / "checkpoint" / f"ckpt_{steps:010d}.npz")
        require([a.shape for a in mine] == [b.shape for b in theirs],
                f"{tag}: the checkpoint's leaves are not the one-process "
                f"layout")
        gap = _ckpt_gap(mine, theirs, steps, lr)
        require(_ckpt_ok(gap),
                f"({c_}) {tag} checkpoint vs one process: {_ckpt_text(gap)}"
                f" (limits: share {PAR_CKPT_OFF} at rel {PAR_CKPT_REL}, "
                f"gap ratio {PAR_CKPT_WORST})")
        lines = []
        for r, res in enumerate(ranks):
            plain, dt, c, peak = res[f"trainer_{tag}"]
            require(c["gn_swish"] > 0 and c["spatial_attention"] > 0,
                    f"{tag} trainer launches {c}")
            if dev.type == "cuda":
                require(c["gn_swish_backward"] > 0 and plain == 0,
                        f"({c_}) {tag} trainer rank {r}: gn_swish_backward "
                        f"launches {c['gn_swish_backward']}, GN+Swish's "
                        f"plain version on the card {plain} times")
            add(c)
            lines.append(f"rank {r}: {dt:.1f} s, peak {peak:.2f} GiB, "
                         f"launches {c}")
        print(f"    ({c_}) Trainer via the CLI at mesh "
              + ("[2, 1]" if tag == "dp"
                 else "[1, 2] (TP, tp_min_channels 128)")
              + f", {steps} steps ({label}): losses "
              f"{[f'{v:.5f}' for v in got]} vs one process "
              f"{[f'{v:.5f}' for v in ref_losses[:steps]]} (largest gap "
              f"{loss_gap(got):.3g} of the loss, rtol {PAR_TRAIN_RTOL}); "
              f"checkpoint written by rank 0 alone in the one-process "
              f"layout ({len(mine)} leaves) vs one process's: "
              f"{_ckpt_text(gap)}; " + "; ".join(lines))
        if tag == "dp":
            continue
        # the control of (d): the split weights gathered in the wrong order
        gap = _ckpt_gap(_swapped(mine, int(tcfg.tpu.tp_min_channels)),
                        theirs, steps, lr)
        require(not _ckpt_ok(gap), f"(d) control: a checkpoint with its "
                f"split weights gathered in reverse order passes: "
                f"{_ckpt_text(gap)}")
        print(f"    (d) control, the split weights gathered in reverse rank "
              f"order: {_ckpt_text(gap)} (must fail)")
    # the control of (c): no gradient averaging, 2 steps
    got = _losses(tmp / "out" / "par_dp_control")
    gap = _ckpt_gap(ckpt("dp_control", 2), npz_leaves(
        one / "checkpoint" / "ckpt_0000000002.npz"), 2, lr)
    require(not _ckpt_ok(gap), f"(c) control: the checkpoint of a run "
            f"without gradient averaging passes: {_ckpt_text(gap)}")
    print(f"    (c) control, each rank stepping on its own rows' gradient: "
          f"losses {[f'{v:.5f}' for v in got]} (largest gap "
          f"{loss_gap(got):.3g} of the loss); checkpoint {_ckpt_text(gap)} "
          f"(must fail)")
    # one process loads the DP run's checkpoint
    mods = build_joint(tcfg, device=dev, flame=flame)
    meta = load_train_state(tmp / "out" / "par_dp" / "checkpoint"
                            / "ckpt_0000000003.npz", mods,
                            init_train_state(mods, tcfg))
    require(int(meta["global_step"]) == 3, f"loaded meta {meta}")
    del mods
    print(f"    one process loaded the mesh run's checkpoint (global step "
          f"3); one-process Trainer {t_one:.1f} s; the ranks' jobs "
          f"{t_ranks:.1f} s; {smi_line() if dev.type == 'cuda' else ''}")
    return counts


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sr3d_torch.kernels import _build, launch_counts, reset_launch_counts
    from sr3d_torch.models.flame import synthetic_flame
    from sr3d_torch.serve import Predictor

    watch_plain_gn()
    # 1. device
    dev = torch.device("cuda")
    print(f"[1] device: {smi_line()}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("    TF32 off for cuDNN convolutions and matmuls (fp32 checks)")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2] built {sorted(_build.build_log) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for stem, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"    {stem}: {line.strip()}")

    # 3. kernels against their plain versions; the slices on a tiny input
    print("[3] kernels vs plain versions (device times, CUDA graphs)")
    rec = phase_kernels(dev)
    rec["spatial_attention"].update(phase_attention_unet(dev))
    rec.update(phase_gn_backward(dev))
    rec.update(phase_conv_kernels(dev))
    print("    conv3x3 and fused_gn_swish_conv3x3 are on no model path (as "
          "in the JAX package): 0 launches on the main paths")
    rec.update(phase_int8_conv(dev))
    config_shapes = phase_config_shapes(dev)
    phase_gradients(dev)
    phase_tiny_slice(dev)
    phase_tiny_train(dev)

    # 4. serving, DDIM-25
    cfg = serving_cfg("ddim")
    flame_kw = dict(n_vertices=5023, n_shape=300, n_exp=100, n_faces=9976,
                    seed=0)
    flame = synthetic_flame(**flame_kw, device=dev)
    t0 = time.perf_counter()
    p = Predictor.from_config(cfg, init_seed=0, batch_size=8, flame=flame)
    n_unet, n_arc = (sum(x.numel() for x in m.parameters()) / 1e6
                     for m in (p.modules.unet, p.modules.arcface))
    print(f"[4] DDIM-25 predictor built in {time.perf_counter() - t0:.1f} s "
          f"(unet {n_unet:.1f}M params, arcface {n_arc:.1f}M); warmup "
          f"{p.warmup():.2f} s")
    norms: list[torch.Tensor] = []
    hook = p.modules.mapping.register_forward_pre_hook(
        lambda _m, args: norms.append(args[0].norm(dim=1)))
    rng = np.random.RandomState(0)
    req_a = rng.randint(0, 256, (8, 16, 16, 3), np.uint8)
    req_b = rng.randint(0, 256, (3, 16, 16, 3), np.uint8)
    reset_launch_counts()
    out_a, t_a = serve(p, req_a)
    out_b, t_b = serve(p, req_b)
    ddim_counts = launch_counts()
    hook.remove()
    check_outputs(out_a, 8, 5023, 300)
    check_outputs(out_b, 3, 5023, 300)
    n = torch.cat(norms)
    require(torch.allclose(n, torch.ones_like(n), atol=1e-3),
            f"embedding norms {n}")
    chunks = 2
    want = {"gn_stats": 0, "gn_swish": chunks * 55 * 25,
            "gn_swish_backward": 0, "spatial_attention": chunks * 25,
            "conv3x3": 0, "fused_gn_swish_conv3x3": 0, "int8_conv": 0}
    require(ddim_counts == want, f"DDIM launches {ddim_counts}, want {want}")
    print(f"    request of 8: {t_a * 1e3:.1f} ms = {8 / t_a:.2f} faces/s; "
          f"request of 3 (padded to 8): {t_b * 1e3:.1f} ms")
    print(f"    outputs finite, shapes and dtypes right, embeddings unit norm"
          f" (max |norm-1| {float((n - 1).abs().max()):.2g}); launches "
          f"{ddim_counts} = 2 chunks x (55 x 25 GN+Swish, one launch "
          f"each, 25 attention)")
    del p

    # 4b. serving, DPM-Solver++(2M), 25 steps, η = 0
    p = Predictor.from_config(serving_cfg("dpm++"), init_seed=0,
                              batch_size=8, flame=flame)
    require((p.modules.val_sampler, p.modules.dpmpp_eta) == ("dpm++", 0.0),
            "the dpm++ predictor's sampler")
    reset_launch_counts()
    out_d, t_d = serve(p, req_a)
    dpm_counts = launch_counts()
    check_outputs(out_d, 8, 5023, 300)
    require(dpm_counts == {"gn_stats": 0, "gn_swish": 55 * 25,
                           "gn_swish_backward": 0, "spatial_attention": 25,
                           "conv3x3": 0, "fused_gn_swish_conv3x3": 0,
                           "int8_conv": 0},
            f"dpm++ launches {dpm_counts}")
    print(f"    dpm++ (2M, eta 0, marginal init, 25 steps), request of 8: "
          f"{t_d * 1e3:.1f} ms = {8 / t_d:.2f} faces/s; outputs finite, "
          f"shapes and dtypes right; launches {dpm_counts}")
    del p

    # 5. serving, ancestral T=600
    cfg = serving_cfg("ddpm")
    p = Predictor.from_config(cfg, init_seed=0, batch_size=1, flame=flame)
    reset_launch_counts()
    out_c, t_c = serve(p, req_a[:1])
    anc_counts = launch_counts()
    check_outputs(out_c, 1, 5023, 300)
    T = 600
    require(anc_counts == {"gn_stats": 0, "gn_swish": 55 * T,
                           "gn_swish_backward": 0, "spatial_attention": T,
                           "conv3x3": 0, "fused_gn_swish_conv3x3": 0,
                           "int8_conv": 0},
            f"ancestral launches {anc_counts}")
    print(f"[5] ancestral T={T}, one face: {t_c:.2f} s (first request, "
          f"includes cuDNN plan selection at batch 1); launches {anc_counts}")

    # 6. training, full width
    del p
    train_counts, _, bare_step_s = phase_training(dev, flame)

    # 7. model3 training, full width
    model3_counts = phase_model3(dev, flame)

    # 8-9. a trained checkpoint served, and the serving CLI
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt = phase_checkpoints(dev, flame, Path(tmp), req_a)
        cli_counts, fwd_launches = phase_cli(dev, ckpt, Path(tmp))
    rec["int8_conv"]["forward_launches"] = fwd_launches

    # 10. the joint Trainer through the training CLI; 11. the staged
    # workflow's branch trainers on the same data
    # 12. the evaluation and asset tools (NoW on phase 10's checkpoint)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer_counts, overlay = phase_trainer(dev, flame, Path(tmp),
                                                bare_step_s)
        now_ckpt = Path(tmp) / "trainer_step6.npz"
        shutil.copy(Path(tmp) / "trainer" / "out" / "trainer_smoke"
                    / "checkpoint" / "ckpt_0000000006.npz", now_ckpt)
        staged = phase_staged(dev, Path(tmp), overlay)
        tools_counts = phase_tools(dev, Path(tmp), now_ckpt)
        # 13. the parallel layer, on phase 10's data
        (Path(tmp) / "par").mkdir()
        par_counts = phase_parallel(dev, flame_kw, Path(tmp) / "par",
                                    overlay)
    require(par_counts["gn_stats"] > 0,
            "phase 13's spatial path launched no gn_stats")

    kernels = []
    meta = {
        "gn_stats": ("sr3d_torch/kernels/csrc/groupnorm_swish.cu",
                     "sr3d_tpu/kernels/groupnorm_swish.py:40"),
        "gn_swish": ("sr3d_torch/kernels/csrc/groupnorm_swish.cu",
                     "sr3d_tpu/kernels/groupnorm_swish.py:178"),
        "gn_swish_backward": (
            "sr3d_torch/kernels/csrc/groupnorm_swish.cu",
            "sr3d_tpu/kernels/groupnorm_swish.py:96 (XLA's autodiff of "
            "groupnorm_swish_reference; no Pallas kernel)"),
        "spatial_attention": ("sr3d_torch/kernels/csrc/attention.cu",
                              "sr3d_tpu/kernels/attention.py:48"),
        "fused_gn_swish_conv3x3": ("sr3d_torch/kernels/csrc/conv3x3.cu",
                                   "sr3d_tpu/kernels/fused_block.py:94"),
        "conv3x3": ("sr3d_torch/kernels/csrc/conv3x3.cu",
                    "sr3d_tpu/kernels/conv3x3.py:61"),
        "int8_conv": ("sr3d_torch/kernels/csrc/int8_conv.cu",
                      "sr3d_tpu/ops/quant.py:42"),
    }
    for name, (src, replaces) in meta.items():
        r = rec[name]
        # launches: the serving requests' (phase 4, bf16); int8_conv's main
        # path is the CLI's int8 default (phase 9), gn_stats's the spatial
        # request of phase 13 (b) (summed over phase 13's paths),
        # gn_swish_backward's training (phase 6's three steps)
        main_counts = {"int8_conv": cli_counts, "gn_stats": par_counts,
                       "gn_swish_backward": train_counts
                       }.get(name, ddim_counts)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_counts[name],
                        "serving_launches": ddim_counts[name],
                        "cli_launches": cli_counts[name],
                        "train_launches": train_counts[name],
                        "model3_launches": model3_counts[name],
                        "trainer_launches": trainer_counts[name],
                        "sr_only_launches": staged["sr_only"][name],
                        "legacy_launches": staged["legacy"][name],
                        "tools_launches": tools_counts[name],
                        "parallel_launches": par_counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "shapes": r["shapes"]})
        if name in config_shapes:
            kernels[-1]["repo_config_shapes"] = len(config_shapes[name])
        for extra in ("main_path", "cudnn_bf16_ms", "cold_ms",
                      "cold_bound_ms", "convs_per_forward", "forward_ms",
                      "forward_launches", "training_shapes", "plan_paths",
                      "long_path_unet"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
