"""Spatial attention on the card at ``chip_smoke.py`` phase 3's shapes.

    python -m sr3d_torch.profile_attention [--check-only] [--json PATH]
    python -m sr3d_torch.profile_attention --tiles | --phases

For each shape and dtype (bf16, fp32): ``attn_plan``'s path and cluster,
the largest error against the plain version, and the device time
(CUDA-graph replay between CUDA events, inputs rotated over more than the
50 MB L2) of ``spatial_attention``, of its plain version and of
``F.scaled_dot_product_attention`` on 4-D views (the yardstick; the port
never calls it), beside the bound: the larger of the bytes (q, k, v read
once, out written once) over 3.35 TB/s and the 4·B·HW²·C operations over
the dtype's peak (989 TF/s bf16 on the tensor cores, 67 TF/s fp32).  Then
the kernels alone at ragged shapes (``--check-only``: those checks and no
timing).  The same script runs in another checkout of the repo to time
its kernels in the same call.

``--tiles`` builds ``attn_tiled_kernel`` from a copy of
``csrc/attention.cu`` with other query-tile rows and key-tile widths and
times each at the long and simt shapes (how the source's tiles were
chosen); ``--phases`` builds a copy with ``clock64`` stamps around each
step of its loop and prints the cycles an iteration each step takes
(warp 0 of each CTA, summed over CTAs).  Both build into
``build/kernels/variants/``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess

import torch
import torch.nn.functional as F

from .kernels import _build, spatial_attention
from .kernels.attention import attn_plan, spatial_attention_reference
from .profile_conv import device_ms

SHAPES = ((8, 64, 512), (4, 64, 512), (2, 64, 512), (1, 64, 512),
          (2, 256, 128), (8, 4, 512), (8, 1024, 512), (1, 4096, 512))
# ragged tiles, C % 8 != 0, C > 512 (more than one slice a rank), one key
# past a tile, B at the grid's limit of 65535
RAGGED = ((2, 16, 36), (1, 37, 40), (1, 100, 200), (1, 256, 1024),
          (1, 300, 40), (1, 257, 64), (2, 1024, 256), (1, 2049, 512),
          (1, 520, 1032), (3, 33, 9), (1, 1, 512), (65535, 4, 8))
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 8e-3)}
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype).cuda()
                 for _ in range(3))


def check(shape, dtype) -> float:
    """The kernel against the plain version: its largest error; raises
    past the tolerance or where repeats differ."""
    q, k, v = _inputs(shape, dtype, 7)
    out = spatial_attention(q, k, v)
    ref = spatial_attention_reference(q, k, v, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    e = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
        raise RuntimeError(f"attention disagrees at {shape} {dtype}: {e}")
    if not torch.equal(spatial_attention(q, k, v), out):
        raise RuntimeError(f"attention does not repeat at {shape} {dtype}")
    return e


def time_shape(shape, dtype) -> dict:
    B, HW, C = shape
    nbytes = 4 * B * HW * C * (2 if dtype == torch.bfloat16 else 4)
    n = max(2, min(64, math.ceil(128e6 / nbytes)))
    sets = [_inputs(shape, dtype, 100 + i) for i in range(n)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return sets[state["i"]]

    def sdpa():
        q, k, v = nxt()
        return F.scaled_dot_product_attention(q[:, None], k[:, None],
                                              v[:, None], scale=C ** -0.5)

    plan = attn_plan(HW, C, dtype)
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = 4 * B * HW * HW * C / PEAK[dtype] * 1e3
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "path": plan.path, "cluster": plan.cluster,
            "max_abs_err": check(shape, dtype),
            "ms": device_ms(lambda: spatial_attention(*nxt())),
            "plain_ms": device_ms(
                lambda: spatial_attention_reference(*nxt(), C ** -0.5)),
            "library_ms": device_ms(sdpa),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# (dtype, query rows, keys a tile) of attn_tiled_kernel to build and time;
# the source's own tiles first
TILES = ((torch.bfloat16, 64, 64), (torch.bfloat16, 64, 32),
         (torch.bfloat16, 128, 32), (torch.bfloat16, 128, 64),
         (torch.float32, 64, 64), (torch.float32, 64, 32))
TILE_SHAPES = {torch.bfloat16: ((8, 1024, 512), (1, 4096, 512),
                                (2, 256, 128), (8, 64, 512)),
               torch.float32: ((8, 1024, 512), (8, 64, 512), (2, 256, 128))}
SMEM_PER_SM = 232448  # bytes two CTAs an SM must fit in, with 1 KB each


def _variant(tag: str, src: str):
    """``sr3d_attention_tiled_fwd`` of ``src`` built as its own library."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{tag}.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(out / f"{tag}.so"), str(out / f"{tag}.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / f"{tag}.so"))
    fn = lib.sr3d_attention_tiled_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, ctypes.c_float, I, I, I, P]
    return lib, fn


def _launch(fn, q, k, v, out) -> None:
    B, HW, C = q.shape
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                HW, C, C ** -0.5, int(q.dtype == torch.bfloat16),
                attn_plan(HW, C, q.dtype).cluster, 1,
                torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"variant launch failed with error {status}")


def tiles() -> None:
    src = (_build.CSRC / "attention.cu").read_text()
    for dtype, qt, kt in TILES:
        name = ("__nv_bfloat16" if dtype == torch.bfloat16 else "float")
        head = f"struct Tiled<{name}> {{"
        a = src.index(head)
        b = src.index("};", a)
        el = 2 if dtype == torch.bfloat16 else 4
        lds = (72, 72, 72, kt + 8) if el == 2 else (68, 68, 72, kt + 4)
        smem = (qt * lds[0] + 3 * kt * (lds[1] + lds[2])
                + 2 * qt * lds[3]) * el + 2 * (qt + 7) * (kt + 8) * 4
        blocks = 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1
        body = re.sub(r"QT = \d+", f"QT = {qt}", src[a:b])
        body = re.sub(r"KT = \d+", f"KT = {kt}", body)
        body = re.sub(r"kMinBlocks = \d+", f"kMinBlocks = {blocks}", body)
        _, fn = _variant(f"tiles_{name}_{qt}_{kt}", src[:a] + body + src[b:])
        row = []
        for shape in TILE_SHAPES[dtype]:
            q, k, v = _inputs(shape, dtype, 3)
            out = torch.empty_like(q)
            _launch(fn, q, k, v, out)
            ref = spatial_attention_reference(q, k, v, shape[-1] ** -0.5)
            atol, rtol = TOL[dtype]
            if not torch.allclose(out.float(), ref.float(), atol=atol,
                                  rtol=rtol):
                raise RuntimeError(f"tiles {qt}x{kt} wrong at {shape}")
            row.append(f"{list(shape)} "
                       f"{device_ms(lambda: _launch(fn, q, k, v, out)):.4f}")
        print(f"tiled {str(dtype).split('.')[-1]} {qt} rows x {kt} keys "
              f"({blocks} CTA(s) an SM): " + " | ".join(row) + " ms",
              flush=True)


# the loop's steps: each ends where its anchor starts
STEPS = (("cluster wait", "    if (tid == 0) {  // arm this iteration's"),
         ("arm, loads", "    if (u >= 0 && u < NU) {  // (a) tile u's partials"),
         ("send partials", "    if (u >= 1 && u <= NU) {  // (b) tile u - 1"),
         ("softmax, send P", "    if (u - 2 >= T_) {  // (c) P V"),
         ("P V", "    cluster_arrive_relaxed();  // this iteration's"),
         ("arrive, K/V wait", "    if (u + 1 < NU) {\n#pragma unroll\n"
                              "      for (int j = 0; j < KW / 8; ++j)"),
         ("scores", "  }\n  cluster_wait();\n}\n"))


def phases() -> None:
    src = (_build.CSRC / "attention.cu").read_text()
    n = len(STEPS)
    src = src.replace(
        "template <typename T>\n__global__ void __launch_bounds__("
        "kTiledThreads",
        f"__device__ unsigned long long g_steps[{n + 1}];\n"
        "template <typename T>\n__global__ void __launch_bounds__("
        "kTiledThreads", 1)
    loop = "  for (int u = -1; u <= NU + 1; ++u) {\n"
    if loop not in src:
        raise RuntimeError("the tiled kernel's loop has changed")
    src = src.replace(loop, "  unsigned long long t_ = clock64(), "
                      f"s_[{n}] = {{}};\n" + loop, 1)
    for i, (_, anchor) in enumerate(STEPS):
        if anchor not in src:
            raise RuntimeError(f"the tiled kernel's step {i} has changed")
        stamp = (f"{{ const unsigned long long c_ = clock64(); s_[{i}] += "
                 f"c_ - t_; t_ = c_; }}\n")
        if i == n - 1:   # the loop's end: stamp inside it, then report
            src = src.replace(anchor, stamp + "  }\n  cluster_wait();\n"
                              f"  if (threadIdx.x == 0) {{\n    for (int i = 0;"
                              f" i < {n}; ++i) atomicAdd(&g_steps[i], s_[i]);"
                              f"\n    atomicAdd(&g_steps[{n}], 1ull);\n  }}\n}}"
                              "\n", 1)
        else:
            src = src.replace(anchor, stamp + anchor, 1)
    src += (f"\nextern \"C\" int read_steps(unsigned long long* o) {{\n"
            f"  return (int)cudaMemcpyFromSymbol(o, g_steps, {8 * (n + 1)});"
            f"\n}}\nextern \"C\" int zero_steps() {{\n  unsigned long long "
            f"z[{n + 1}] = {{}};\n  return (int)cudaMemcpyToSymbol(g_steps, z,"
            f" sizeof(z));\n}}\n")
    lib, fn = _variant("phases", src)
    for shape, dtype in (((8, 1024, 512), torch.bfloat16),
                         ((1, 4096, 512), torch.bfloat16),
                         ((8, 64, 512), torch.float32),
                         ((8, 1024, 512), torch.float32)):
        q, k, v = _inputs(shape, dtype, 3)
        out = torch.empty_like(q)
        _launch(fn, q, k, v, out)   # warm
        lib.zero_steps()
        _launch(fn, q, k, v, out)
        torch.cuda.synchronize()
        acc = (ctypes.c_ulonglong * (n + 1))()
        lib.read_steps(acc)
        ctas = acc[n]
        kt = 64
        iters = 2 * -(-shape[1] // kt) + 3
        total = sum(acc[:n]) / ctas
        print(f"{list(shape)} {str(dtype).split('.')[-1]}: {ctas} CTAs, "
              f"{iters} iterations, {total / iters:.0f} cycles an "
              f"iteration: " + ", ".join(
                  f"{name} {acc[i] / ctas / iters:.0f} "
                  f"({100 * acc[i] / ctas / total:.0f}%)"
                  for i, (name, _) in enumerate(STEPS)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tiles or args.phases:
        return tiles() if args.tiles else phases()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            if args.check_only:
                print(f"{list(shape)} {dtype}: path "
                      f"{attn_plan(shape[1], shape[2], dtype).path} err "
                      f"{check(shape, dtype):.3g}", flush=True)
                continue
            r = time_shape(shape, dtype)
            rows.append(r)
            print(f"{r['shape']} {r['dtype']}: path {r['path']} (cluster "
                  f"{r['cluster']}) err {r['max_abs_err']:.3g}  kernel "
                  f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} sdpa "
                  f"{r['library_ms']:.4f} bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']})", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in RAGGED:
            print(f"{list(shape)} {dtype}: path "
                  f"{attn_plan(shape[1], shape[2], dtype).path} err "
                  f"{check(shape, dtype):.3g}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
