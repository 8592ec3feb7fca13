// GroupNorm + Swish for Hopper (sm_90a): a statistics pass and an apply pass.
//
// Replaces two TPU kernels of sr3d_tpu/kernels/groupnorm_swish.py:
//   * _gn_stats_pallas (_stats_kernel): per-channel sum and sum of squares
//     over (H, W) in fp32  ->  gn_stats_kernel below;
//   * _gn_swish_pallas (_gn_swish_kernel): GroupNorm with one-pass fp32
//     statistics, E[x^2] - E[x]^2 clamped at 0, eps, then the gamma/beta
//     affine and swish, written in x's type  ->  gn_swish_apply_kernel.
//
// Layout: x is NCHW, so each (b, c) plane of H*W values is contiguous.
// gn_stats_nhwc_kernel computes the same moments of an NHWC x (the layout
// of the TPU kernel itself) for the fused GN -> Swish -> conv3x3 block of
// conv3x3.cu; gn_stats_nhwc_vec_kernel does it with 16-byte loads where C
// allows.
//
// What bounds it on an H100: memory.  The work is a handful of flops per
// element against 2 (bf16) or 4 (fp32) bytes, far below the ~295 flop/byte
// the card needs before compute matters.  The least traffic is one read of
// x for the statistics and one read plus one write for the apply.
//
// Design:
//   * The TPU kernel held one image's [HW, C] block in VMEM and did both
//     passes on it.  At the 16->128 config that block is up to 128^2 x 192
//     bf16 = 6.3 MB, far beyond the 227 KB of shared memory a Hopper block
//     has, so the port splits it into two kernels and x is read twice.
//   * Stats: one block per (b, c) plane.  Threads stream the plane with
//     16-byte loads, accumulate in fp32 registers, then reduce with a warp
//     shuffle tree and a fixed-order pass over the warps' partials.  No
//     atomics, so the sums are the same on every run.
//   * Apply: a 2-D grid of (plane, chunk of the plane).  Thread 0 of each
//     block combines the C/G channel sums of its group into the group mean
//     and rstd (the group is tiny, so every block recomputes it rather than
//     paying a third launch), folds them with gamma into a = rstd * gamma,
//     and every thread writes swish((x - mean) * a + beta) with 16-byte
//     loads and stores.  (x - mean) is taken before the scale rather than
//     folding mean into the shift (b = beta - mean * a): for a near-constant
//     map with a large mean, a * x and mean * a are ~1e6 and their f32
//     difference would lose the result.
//   * Non-16-byte-aligned planes (H*W not a multiple of the vector width)
//     take a scalar loop; the main path's shapes never do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kApplyIters = 4;  // 16-byte vectors per thread per apply block

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x,
                                float* __restrict__ sum,
                                float* __restrict__ sumsq,
                                int64_t hw, int vec) {
  constexpr int N = 16 / sizeof(T);
  const int64_t plane = blockIdx.x;
  const T* p = x + plane * hw;
  float s = 0.f, q = 0.f;
  if (vec) {
    const int4* pv = reinterpret_cast<const int4*>(p);
    const int64_t nv = hw / N;
    for (int64_t i = threadIdx.x; i < nv; i += blockDim.x) {
      int4 raw = __ldg(pv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float v = to_f<T>(e[j]);
        s += v;
        q += v * v;
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
      const float v = to_f<T>(p[i]);
      s += v;
      q += v * v;
    }
  }
  __shared__ float ws[32], wq[32];
  s = warp_sum(s);
  q = warp_sum(q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? ws[lane] : 0.f;
    q = lane < nw ? wq[lane] : 0.f;
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      sum[plane] = s;
      sumsq[plane] = q;
    }
  }
}

// The same moments of an NHWC x (channels innermost), for the fused
// GN -> Swish -> conv3x3 block, whose public layout is the JAX package's.
// Block (32, 8): 32 neighbouring channels x 8 pixel rows, so a warp reads
// 32 consecutive channels of one pixel.  Grid (channel tiles, pixel splits,
// batch); each block writes its partial sums to [B, splits, C] and the
// wrapper adds the splits in a fixed order, so the sums are reproducible.
template <typename T>
__global__ void gn_stats_nhwc_kernel(const T* __restrict__ x,
                                     float* __restrict__ psum,
                                     float* __restrict__ psumsq, int64_t hw,
                                     int C, int64_t per_split) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int64_t b = blockIdx.z;
  const int64_t p0 = (int64_t)blockIdx.y * per_split;
  const int64_t p1 = p0 + per_split < hw ? p0 + per_split : hw;
  float s = 0.f, q = 0.f;
  if (c < C) {
    const T* px = x + b * hw * C + c;
    for (int64_t p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
      const float v = to_f<T>(px[p * C]);
      s += v;
      q += v * v;
    }
  }
  __shared__ float ss[8][33], sq[8][33];
  ss[threadIdx.y][threadIdx.x] = s;
  sq[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int r = 1; r < (int)blockDim.y; ++r) {
      s += ss[r][threadIdx.x];
      q += sq[r][threadIdx.x];
    }
    const int64_t o = (b * gridDim.y + blockIdx.y) * C + c;
    psum[o] = s;
    psumsq[o] = q;
  }
}

// The same, 16 bytes a thread: block (C/N, rows), thread x owns channels
// N*x .. N*x+N-1 (N = 16 / sizeof(T)) of pixels y, y + rows, ... of the
// block's split, so a warp reads 512 contiguous bytes.  The rows' partials
// are added in row order in shared memory (2 * rows * C floats).
template <typename T>
__global__ void gn_stats_nhwc_vec_kernel(const T* __restrict__ x,
                                         float* __restrict__ psum,
                                         float* __restrict__ psumsq,
                                         int64_t hw, int C,
                                         int64_t per_split) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float red[];  // [2][rows][C]
  const int64_t b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * per_split;
  const int64_t p1 = p0 + per_split < hw ? p0 + per_split : hw;
  float s[N], q[N];
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] = q[e] = 0.f;
  const T* px = x + b * hw * C + threadIdx.x * N;
#pragma unroll 4
  for (int64_t p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(px + p * C));
    const T* e8 = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float f = to_f<T>(e8[e]);
      s[e] += f;
      q[e] += f * f;
    }
  }
  const int rows = blockDim.y;
  float* rs = red + (threadIdx.y * C + threadIdx.x * N);
  float* rq = rs + rows * C;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    rs[e] = s[e];
    rq[e] = q[e];
  }
  __syncthreads();
  for (int c = threadIdx.y * blockDim.x + threadIdx.x; c < C;
       c += blockDim.x * rows) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < rows; ++r) {
      ts += red[r * C + c];
      tq += red[(rows + r) * C + c];
    }
    const int64_t o = (b * gridDim.x + blockIdx.x) * C + c;
    psum[o] = ts;
    psumsq[o] = tq;
  }
}

template <typename T>
__global__ void gn_swish_apply_kernel(const T* __restrict__ x,
                                      const float* __restrict__ sum,
                                      const float* __restrict__ sumsq,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      T* __restrict__ y, int C, int G,
                                      int64_t hw, float eps, int vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int64_t kChunk = (int64_t)kThreads * N * kApplyIters;
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % C);
  const int64_t b = plane / C;
  __shared__ float s_mean, s_a;
  if (threadIdx.x == 0) {
    const int cg = C / G;
    const int64_t g0 = b * C + (int64_t)(c / cg) * cg;
    float gs = 0.f, gq = 0.f;
    for (int i = 0; i < cg; ++i) {
      gs += sum[g0 + i];
      gq += sumsq[g0 + i];
    }
    const float n = (float)(hw * cg);
    const float mean = gs / n;
    const float var = fmaxf(gq / n - mean * mean, 0.f);
    s_mean = mean;
    s_a = (1.f / sqrtf(var + eps)) * gamma[c];
  }
  __syncthreads();
  const float mean = s_mean, a = s_a, shift = beta[c];
  const T* px = x + plane * hw;
  T* py = y + plane * hw;
  const int64_t start = (int64_t)blockIdx.y * kChunk;
  const int64_t end = start + kChunk < hw ? start + kChunk : hw;
  if (vec) {
    for (int64_t i = start + (int64_t)threadIdx.x * N; i < end;
         i += (int64_t)blockDim.x * N) {
      int4 raw = __ldg(reinterpret_cast<const int4*>(px + i));
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float v = (to_f<T>(e[j]) - mean) * a + shift;
        e[j] = from_f<T>(v / (1.f + expf(-v)));
      }
      *reinterpret_cast<int4*>(py + i) = raw;
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
      const float v = (to_f<T>(px[i]) - mean) * a + shift;
      py[i] = from_f<T>(v / (1.f + expf(-v)));
    }
  }
}

int vector_ok(const void* p, int64_t hw, int elem_bytes) {
  return (hw % (16 / elem_bytes)) == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x: [planes, hw] with planes = B*C; sum, sumsq: [planes] fp32.
// is_bf16: 1 for bfloat16 x, 0 for float32.  Returns cudaGetLastError().
int sr3d_gn_stats(const void* x, void* sum, void* sumsq, int64_t planes,
                  int64_t hw, int is_bf16, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  const int vec = vector_ok(x, hw, elem);
  const int64_t work = vec ? hw / (16 / elem) : hw;
  int threads = kThreads;
  if (work < kThreads) threads = (int)((work + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gn_stats_kernel<__nv_bfloat16><<<(unsigned)planes, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(sum),
        static_cast<float*>(sumsq), hw, vec);
  } else {
    gn_stats_kernel<float><<<(unsigned)planes, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(sum),
        static_cast<float*>(sumsq), hw, vec);
  }
  return (int)cudaGetLastError();
}

// x: [batch, hw, C] (NHWC); psum, psumsq: [batch, splits, C] fp32 partial
// moments, splits = ceil(hw / per_split).  Returns cudaGetLastError().
int sr3d_gn_stats_nhwc(const void* x, void* psum, void* psumsq, int batch,
                       int64_t hw, int C, int64_t per_split, int is_bf16,
                       void* stream) {
  if (batch < 1 || hw < 1 || C < 1 || per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = is_bf16 ? 8 : 4;  // channels in 16 bytes
  const int64_t splits = (hw + per_split - 1) / per_split;
  // the vector kernel has one block a split: below ~one wave (the 8x8
  // levels) the channel-tiled kernel spreads wider
  if (C % n == 0 && C / n <= 256 && splits * batch >= 128 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int cg = C / n, rows = 256 / cg;
    dim3 block((unsigned)cg, (unsigned)rows);
    dim3 grid((unsigned)splits, (unsigned)batch);
    const size_t smem = 2 * (size_t)rows * C * sizeof(float);
    if (is_bf16)
      gn_stats_nhwc_vec_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<float*>(psum),
          static_cast<float*>(psumsq), hw, C, per_split);
    else
      gn_stats_nhwc_vec_kernel<float><<<grid, block, smem, s>>>(
          static_cast<const float*>(x), static_cast<float*>(psum),
          static_cast<float*>(psumsq), hw, C, per_split);
    return (int)cudaGetLastError();
  }
  dim3 block(32, 8);
  dim3 grid((unsigned)((C + 31) / 32),
            (unsigned)((hw + per_split - 1) / per_split), (unsigned)batch);
  if (is_bf16) {
    gn_stats_nhwc_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(psum),
        static_cast<float*>(psumsq), hw, C, per_split);
  } else {
    gn_stats_nhwc_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(psum),
        static_cast<float*>(psumsq), hw, C, per_split);
  }
  return (int)cudaGetLastError();
}

// y = swish(groupnorm(x) * gamma + beta) from the per-channel moments.
// x, y: [B, C, hw]; sum, sumsq: [B, C] fp32; gamma, beta: [C] fp32.
int sr3d_gn_swish_apply(const void* x, const void* sum, const void* sumsq,
                        const void* gamma, const void* beta, void* y,
                        int64_t batch, int C, int G, int64_t hw, float eps,
                        int is_bf16, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  const int vec = vector_ok(x, hw, elem) && vector_ok(y, hw, elem);
  const int64_t chunk = (int64_t)kThreads * (16 / elem) * kApplyIters;
  dim3 grid((unsigned)(batch * C), (unsigned)((hw + chunk - 1) / chunk));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gn_swish_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sum),
        static_cast<const float*>(sumsq), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), C,
        G, hw, eps, vec);
  } else {
    gn_swish_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(sum),
        static_cast<const float*>(sumsq), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(y), C, G, hw,
        eps, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
