// GroupNorm + Swish for Hopper (sm_90a): a one-pass kernel that reads x
// once over a thread-block cluster, and a statistics pass + apply pass; and
// the backward of the same function, in one pass over a cluster or in three.
//
// Replaces two TPU kernels of sr3d_tpu/kernels/groupnorm_swish.py:
//   * _gn_stats_pallas (_stats_kernel): per-channel sum and sum of squares
//     over (H, W) in fp32  ->  gn_stats_kernel below;
//   * _gn_swish_pallas (_gn_swish_kernel): GroupNorm with one-pass fp32
//     statistics, E[x^2] - E[x]^2 clamped at 0, eps, then the gamma/beta
//     affine and swish, written in x's type, both passes on chip  ->
//     gn_swish_onepass_kernel, or gn_stats_kernel + gn_swish_apply_kernel.
// The backward has no Pallas kernel to replace: the JAX train step takes
// the gradient by XLA's autodiff of groupnorm_swish_reference
// (sr3d_tpu/kernels/groupnorm_swish.py:96), fused into a few loops.  The
// kernels below compute the same gradient in closed form:
//   gn_bwd_onepass_kernel, or gn_stats_kernel + gn_bwd_reduce_kernel +
//   gn_bwd_dx_kernel.
//
// Layout: x is NCHW, so each (b, c) plane of H*W values is contiguous, and
// so is each (b, group) span of C/G planes.  gn_stats_nhwc_kernel computes
// the same moments of an NHWC x (the layout of the TPU kernel itself) for
// the fused GN -> Swish -> conv3x3 block of conv3x3.cu;
// gn_stats_nhwc_vec_kernel does it with 16-byte loads where C allows.
//
// What bounds it on an H100: memory.  The work is a handful of flops per
// element against 2 (bf16) or 4 (fp32) bytes, far below the ~295 flop/byte
// the card needs before compute matters.  The least traffic is one read and
// one write of x (forward); one read of x and of gy and one write of dx
// (backward).
//
// gn_swish_onepass_kernel<T>: the path of gn_swish wherever the plan
// (gn_plan in groupnorm_swish.py) finds that a group fits on chip; on the
// 16->128 UNet that is every call.
//   * The TPU kernel held one image's [HW, C] block in VMEM (up to 6.3 MB
//     at 128^2 x 192: no SM holds that).  One group does fit a cluster:
//     at most 6 x 128^2 = 98 304 values on the flagship's path, 192 KB in
//     bf16, 384 KB in fp32.
//   * Grid: a cluster of S in {1, 2, 4, 8} CTAs per (b, group); S and the
//     threads come from the plan, which keeps a CTA's share of a group at
//     most 48 KB and gives the card at least two CTAs an SM at B = 8 and
//     at B = 1 where the shares stay >= 8 KB.
//   * Load: rank r takes the contiguous 16-byte vectors [n r / S,
//     n (r + 1) / S) of the group.  One thread copies the share into shared
//     memory with 1-D bulk copies (cp.async.bulk, the TMA engine) that
//     complete on an mbarrier: no thread spends registers or issue slots
//     on the load, and with the data in shared memory, not registers, up to
//     8 CTAs stay resident on an SM, each in its own phase, so one CTA's
//     loads overlap another's stores.  (A first version held the share in
//     registers: 107 registers a thread, 3 CTAs an SM, 1 TB/s.)
//   * Moments: fp32 sums per thread in a fixed order, a warp shuffle tree,
//     a fixed-order pass over the warps.  After a cluster barrier, lane r
//     of warp 0 reads rank r's partials through distributed shared memory
//     (all S loads in flight at once) and lane 0 adds them in rank order.
//     No atomics: every CTA of the cluster gets the same statistics and
//     repeats are bit-equal.  A split arrive/wait keeps every CTA's shared
//     memory alive until the others have read it.
//   * Output: swish((x - mean) * (rstd * gamma_c) + beta_c) from shared
//     memory, in x's type, 16 bytes a thread: x is read once and y written
//     once, in one launch (the first port: two launches, x read twice).
//     exp and the division use the SFU's approximations (__expf,
//     __fdividef; ~1e-6 relative): the accurate ones take several times
//     the instructions, and here the activation runs after the loads
//     instead of hiding behind them as in a streaming kernel.  (x - mean)
//     is taken before the scale rather than folding mean into the shift (b
//     = beta - mean * a): for a near-constant map with a large mean, a * x
//     and mean * a are ~1e6 and their f32 difference would lose the result.
//
// gn_stats_kernel + gn_swish_apply_kernel: the shapes the plan does not
// give the one-pass kernel (H*W not a multiple of the vector width; a group
// larger than a cluster of 8 holds).
//   * Stats: one block per (b, c) plane.  Threads stream the plane with
//     16-byte loads, accumulate in fp32 registers, then reduce with a warp
//     shuffle tree and a fixed-order pass over the warps' partials.
//   * Apply: a 2-D grid of (plane, chunk of the plane).  Thread 0 of each
//     block combines the C/G channel sums of its group into the group mean
//     and rstd, folds them with gamma into a = rstd * gamma, and every
//     thread writes swish((x - mean) * a + beta).
//   * Non-16-byte-aligned planes take a scalar loop.

// The backward.  With xhat = (x - mean) * rstd, z = xhat * gamma_c + beta_c
// and y = swish(z), given gy = dL/dy:
//   dz = gy * s * (1 + z * (1 - s)), s = sigmoid(z);
//   dbeta_c = sum_{b,hw} dz,  dgamma_c = sum_{b,hw} dz * xhat;
//   dx = rstd * (dz * gamma_c - m1 - xhat * m2), with the group terms
//   m1 = sum_{c in g} gamma_c * P_c / n and m2 = the same of Q_c, where
//   P_c, Q_c are the per-(b, c) sums of dz and dz * xhat and n = cg * hw.
// Where the clamp held a group's variance at 0, m2 is 0 (the variance's
// gradient is 0 there, as autograd of the clamp gives it).  So one
// reduction, the per-(b, c) P and Q, gives dgamma, dbeta (P and Q summed
// over b by the wrapper, in a fixed order) and both group terms.
//
// gn_bwd_onepass_kernel<T>: the path of the backward wherever the plan
// (gn_bwd_plan) finds that a group's x and gy fit a cluster; on every
// training path of the 16->128 UNet in bf16, that is every call.
//   * The work against the bound: x and gy must be read and dx written, 3
//     values an element; two reductions (the moments, then P and Q) stand
//     between the reads and the write.  A streaming design reads x and gy
//     twice or three times; this one holds a group's x and gy on chip so
//     each is read once from device memory.
//   * Grid: a cluster of S in {1, 2, 4, 8} CTAs per (b, group), as the
//     forward; rank r holds the 16-byte vectors [n r / S, n (r + 1) / S)
//     of x and of gy in shared memory, brought by one thread with 1-D bulk
//     copies on one mbarrier.  The plan keeps a rank's x + gy at most 64 KB
//     where the cluster can grow, at most 192 KB in all (of the 227 KB a
//     CTA may have): bf16 at 128^2 x 6 channels is 384 KB a group, 48 KB a
//     rank at S = 8; fp32 twice that.
//   * Moments as the forward: per thread, a shuffle tree, the warps in
//     order, then the ranks in order through distributed shared memory.
//   * P and Q: warp w takes the contiguous vectors [cnt w / nw, cnt (w +
//     1) / nw) of the share and walks them one channel's segment at a time
//     (a 16-byte vector never straddles two channels, as hw is a multiple
//     of the vector), so every warp has the same work whether a channel
//     spans many vectors (128^2) or few (8^2); each segment ends in a
//     shuffle tree into a per-warp, per-channel slot.  After one block
//     barrier the slots are added in warp order into this rank's
//     per-channel partials; after a cluster barrier every rank reads every
//     rank's partials, adds them in rank order and forms m1 and m2 with the
//     same arithmetic, so every rank gets the same values; rank 0 writes P
//     and Q.  No atomics: repeats are bit-equal.
//   * dx: recomputed per element from the shared x and gy (z and dz again:
//     the exp is cheaper than the shared memory an fp32 dz would take),
//     16 bytes a thread, written once.  __expf / __fdividef as the forward.
//
// The multi-pass backward, for the shapes the plan rejects (H*W not a
// multiple of the vector width: down to H*W = 1 in the small configs; a
// group of more than 64 channels; a group's x + gy beyond a cluster):
// gn_stats_kernel for the moments, gn_bwd_reduce_kernel (one block per
// (b, c) plane: P and Q in a fixed order), gn_bwd_dx_kernel (elementwise,
// the apply kernel's grid; thread 0 of a block forms m1 and m2 from its
// group's P and Q in channel order).  gy is read twice and x three
// times.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
                                      int64_t hw, int64_t count, float eps,
                                      int vec) {
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
    const float n = (float)(count * cg);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spins until the phase of parity `parity` has completed; a wait that
// never ends (a bug, not a slow copy) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

constexpr int kMaxShareBytes = 65536;  // a CTA's share of a group, at most
constexpr int kBulkBytes = 16384;      // bytes of one bulk copy

// One (b, group) per cluster of S CTAs; see the header.  n: 16-byte vectors
// in a group (cg * hw / N); a rank's share is in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
    gn_swish_onepass_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            T* __restrict__ y, int C, int G, int hw, int n,
                            float eps) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(16) int4 buf[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float ws[8], wq[8], part[2], stat[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t grp = blockIdx.x / S;
  const int cgs = C / G;
  const int g = (int)(grp % G);
  const int64_t base = (grp / G * C + (int64_t)g * cgs) * hw;
  const int v0 = (int)((int64_t)n * rank / S);
  const int cnt = (int)((int64_t)n * (rank + 1) / S) - v0;
  const int4* px = reinterpret_cast<const int4*>(x + base) + v0;
  int4* py = reinterpret_cast<int4*>(y + base) + v0;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(&bar)),
        "r"(cnt * 16)
        : "memory");
    for (int off = 0; off < cnt * 16; off += kBulkBytes) {
      const int bytes = min(kBulkBytes, cnt * 16 - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(buf) + off),
          "l"(reinterpret_cast<const char*>(px) + off), "r"(bytes),
          "r"(smem_u32(&bar))
          : "memory");
    }
  }
  __syncthreads();
  mbar_wait(&bar, 0);

  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int4 raw = buf[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f<T>(e[j]);
      s += f;
      q += f * f;
    }
  }
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
    s = warp_sum(lane < nw ? ws[lane] : 0.f);
    q = warp_sum(lane < nw ? wq[lane] : 0.f);
    if (lane == 0) {
      part[0] = s;
      part[1] = q;
    }
  }
  cluster.sync();
  if (warp == 0) {
    float ps = 0.f, pq = 0.f;
    if (lane < S) {
      const float* p = cluster.map_shared_rank(part, lane);
      ps = p[0];
      pq = p[1];
    }
    float ts = 0.f, tq = 0.f;  // rank order
    for (int r = 0; r < S; ++r) {
      ts += __shfl_sync(0xffffffffu, ps, r);
      tq += __shfl_sync(0xffffffffu, pq, r);
    }
    if (lane == 0) {
      const float count = (float)((int64_t)hw * cgs);
      const float mean = ts / count;
      const float var = fmaxf(tq / count - mean * mean, 0.f);
      stat[0] = mean;
      stat[1] = 1.f / sqrtf(var + eps);
    }
  }
  // the others may leave once every CTA has read the partials
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    int4 raw = buf[i];
    const int c = g * cgs + (v0 + i) * N / hw;
    const float a = rstd * __ldg(gamma + c), shift = __ldg(beta + c);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v = (to_f<T>(e[j]) - mean) * a + shift;
      e[j] = from_f<T>(__fdividef(v, 1.f + __expf(-v)));
    }
    py[i] = raw;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The backward: dx, and the per-(b, c) sums from which dgamma and dbeta come
// (see the header).
// ---------------------------------------------------------------------------

constexpr int kBwdMaxShareBytes = 196608;  // a CTA's x + gy share, at most
constexpr int kBwdMaxCg = 64;              // channels a group, one-pass path

// The group's mean and rstd from its channels' moments, as the apply kernel
// takes them; keep = 0 where the clamp held the variance at 0 (there the
// variance's gradient is 0, as autograd of the clamp gives it).
__device__ __forceinline__ void group_stat(const float* __restrict__ sum,
                                           const float* __restrict__ sumsq,
                                           int64_t g0, int cg, float n,
                                           float eps, float* mean,
                                           float* rstd, float* keep) {
  float gs = 0.f, gq = 0.f;
  for (int i = 0; i < cg; ++i) {
    gs += sum[g0 + i];
    gq += sumsq[g0 + i];
  }
  const float m = gs / n;
  const float raw = gq / n - m * m;
  *mean = m;
  *rstd = 1.f / sqrtf(fmaxf(raw, 0.f) + eps);
  *keep = raw >= 0.f ? 1.f : 0.f;
}

// dL/dz of y = swish(z), given dL/dy = g.
__device__ __forceinline__ float swish_grad(float z, float g) {
  const float s = __fdividef(1.f, 1.f + __expf(-z));
  return g * s * (1.f + z * (1.f - s));
}

// Multi-pass, pass 2: one block per (b, c) plane sums dz and dz * xhat over
// the plane (fixed order: threads, a warp shuffle tree, the warps in turn).
template <typename T>
__global__ void gn_bwd_reduce_kernel(const T* __restrict__ x,
                                     const T* __restrict__ gy,
                                     const float* __restrict__ sum,
                                     const float* __restrict__ sumsq,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float* __restrict__ pdz,
                                     float* __restrict__ pdzx, int C, int G,
                                     int64_t hw, float eps, int vec) {
  constexpr int N = 16 / sizeof(T);
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % C);
  const int64_t b = plane / C;
  __shared__ float s_stat[2], ws[32], wq[32];
  if (threadIdx.x == 0) {
    const int cg = C / G;
    float keep;
    group_stat(sum, sumsq, b * C + (int64_t)(c / cg) * cg, cg,
               (float)(hw * cg), eps, &s_stat[0], &s_stat[1], &keep);
  }
  __syncthreads();
  const float mean = s_stat[0], rstd = s_stat[1];
  const float gam = gamma[c], bet = beta[c];
  const T* px = x + plane * hw;
  const T* pg = gy + plane * hw;
  float p = 0.f, q = 0.f;
  if (vec) {
    for (int64_t i = threadIdx.x; i < hw / N; i += blockDim.x) {
      const int4 rx = __ldg(reinterpret_cast<const int4*>(px) + i);
      const int4 rg = __ldg(reinterpret_cast<const int4*>(pg) + i);
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = (to_f<T>(ex[j]) - mean) * rstd;
        const float dz = swish_grad(xh * gam + bet, to_f<T>(eg[j]));
        p += dz;
        q += dz * xh;
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
      const float xh = (to_f<T>(px[i]) - mean) * rstd;
      const float dz = swish_grad(xh * gam + bet, to_f<T>(pg[i]));
      p += dz;
      q += dz * xh;
    }
  }
  p = warp_sum(p);
  q = warp_sum(q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = p;
    wq[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    p = warp_sum(lane < nw ? ws[lane] : 0.f);
    q = warp_sum(lane < nw ? wq[lane] : 0.f);
    if (lane == 0) {
      pdz[plane] = p;
      pdzx[plane] = q;
    }
  }
}

// Multi-pass, pass 3: dx = rstd * (dz * gamma - m1 - xhat * m2) over a 2-D
// grid of (plane, chunk of the plane), as the apply kernel; thread 0 of a
// block takes the group terms m1 = sum_c gamma_c * pdz_c / n and m2 = the
// same of pdzx (0 where the variance was clamped) in channel order.
template <typename T>
__global__ void gn_bwd_dx_kernel(const T* __restrict__ x,
                                 const T* __restrict__ gy,
                                 const float* __restrict__ sum,
                                 const float* __restrict__ sumsq,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ pdz,
                                 const float* __restrict__ pdzx,
                                 T* __restrict__ dx, int C, int G,
                                 int64_t hw, float eps, int vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int64_t kChunk = (int64_t)kThreads * N * kApplyIters;
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % C);
  const int64_t b = plane / C;
  __shared__ float s_stat[4];
  if (threadIdx.x == 0) {
    const int cg = C / G;
    const int c0 = (c / cg) * cg;
    const int64_t g0 = b * C + c0;
    const float n = (float)(hw * cg);
    float mean, rstd, keep;
    group_stat(sum, sumsq, g0, cg, n, eps, &mean, &rstd, &keep);
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < cg; ++i) {
      t1 += gamma[c0 + i] * pdz[g0 + i];
      t2 += gamma[c0 + i] * pdzx[g0 + i];
    }
    s_stat[0] = mean;
    s_stat[1] = rstd;
    s_stat[2] = t1 / n;
    s_stat[3] = keep * (t2 / n);
  }
  __syncthreads();
  const float mean = s_stat[0], rstd = s_stat[1], m1 = s_stat[2],
              m2 = s_stat[3];
  const float gam = gamma[c], bet = beta[c];
  const T* px = x + plane * hw;
  const T* pg = gy + plane * hw;
  T* pd = dx + plane * hw;
  const int64_t start = (int64_t)blockIdx.y * kChunk;
  const int64_t end = start + kChunk < hw ? start + kChunk : hw;
  if (vec) {
    for (int64_t i = start + (int64_t)threadIdx.x * N; i < end;
         i += (int64_t)blockDim.x * N) {
      const int4 rx = __ldg(reinterpret_cast<const int4*>(px + i));
      const int4 rg = __ldg(reinterpret_cast<const int4*>(pg + i));
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
      int4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = (to_f<T>(ex[j]) - mean) * rstd;
        const float dz = swish_grad(xh * gam + bet, to_f<T>(eg[j]));
        eo[j] = from_f<T>(rstd * (dz * gam - m1 - xh * m2));
      }
      *reinterpret_cast<int4*>(pd + i) = out;
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
      const float xh = (to_f<T>(px[i]) - mean) * rstd;
      const float dz = swish_grad(xh * gam + bet, to_f<T>(pg[i]));
      pd[i] = from_f<T>(rstd * (dz * gam - m1 - xh * m2));
    }
  }
}

// One pass: one (b, group) per cluster of S CTAs; see the header.  n: 16-byte
// vectors of x in a group; share: the vectors a rank's buffers hold, at
// most (x in the first `share`, gy in the next).  dx may be null (no input
// gradient wanted), and so may pdz / pdzx (no gamma / beta gradient).
template <typename T>
__global__ void __launch_bounds__(256)
    gn_bwd_onepass_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ dx,
                          float* __restrict__ pdz, float* __restrict__ pdzx,
                          int C, int G, int hw, int n, int share, float eps) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(16) int4 buf[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float ws[8], wq[8], part[2], stat[5];
  __shared__ float2 wpart[8][kBwdMaxCg];  // per warp, per channel
  __shared__ float2 pch[kBwdMaxCg];       // this rank's, per channel
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t grp = blockIdx.x / S;
  const int cgs = C / G;
  const int g = (int)(grp % G);
  const int64_t bc0 = grp / G * C + (int64_t)g * cgs;  // (b, first channel)
  const int64_t base = bc0 * hw;
  const int vpc = hw / N;  // vectors a channel
  const int v0 = (int)((int64_t)n * rank / S);
  const int cnt = (int)((int64_t)n * (rank + 1) / S) - v0;
  const int4* bx = buf;
  const int4* bg = buf + share;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(&bar)),
        "r"(2 * cnt * 16)
        : "memory");
    const char* src[2] = {reinterpret_cast<const char*>(x + base) + v0 * 16,
                          reinterpret_cast<const char*>(gy + base) + v0 * 16};
    for (int k = 0; k < 2; ++k) {
      const uint32_t dst = smem_u32(buf + k * share);
      for (int off = 0; off < cnt * 16; off += kBulkBytes) {
        const int bytes = min(kBulkBytes, cnt * 16 - off);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst + off),
            "l"(src[k] + off), "r"(bytes), "r"(smem_u32(&bar))
            : "memory");
      }
    }
  }
  for (int i = threadIdx.x; i < nw * kBwdMaxCg; i += blockDim.x)
    wpart[i / kBwdMaxCg][i % kBwdMaxCg] = make_float2(0.f, 0.f);
  __syncthreads();
  mbar_wait(&bar, 0);

  // the moments of x, as the forward takes them
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int4 raw = bx[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f<T>(e[j]);
      s += f;
      q += f * f;
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(lane < nw ? ws[lane] : 0.f);
    q = warp_sum(lane < nw ? wq[lane] : 0.f);
    if (lane == 0) {
      part[0] = s;
      part[1] = q;
    }
  }
  cluster.sync();
  if (warp == 0) {
    float ps = 0.f, pq = 0.f;
    if (lane < S) {
      const float* p = cluster.map_shared_rank(part, lane);
      ps = p[0];
      pq = p[1];
    }
    float ts = 0.f, tq = 0.f;  // rank order
    for (int r = 0; r < S; ++r) {
      ts += __shfl_sync(0xffffffffu, ps, r);
      tq += __shfl_sync(0xffffffffu, pq, r);
    }
    if (lane == 0) {
      const float count = (float)((int64_t)hw * cgs);
      const float mean = ts / count;
      const float raw = tq / count - mean * mean;
      stat[0] = mean;
      stat[1] = 1.f / sqrtf(fmaxf(raw, 0.f) + eps);
      stat[2] = raw >= 0.f ? 1.f : 0.f;
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];

  // per-channel sums of dz and dz * xhat: warp w takes the contiguous
  // vectors [cnt w / nw, cnt (w + 1) / nw) of the share, one channel's
  // segment at a time, so every warp has the same work
  {
    const int hi = (int)((int64_t)cnt * (warp + 1) / nw);
    int i = (int)((int64_t)cnt * warp / nw);
    while (i < hi) {
      const int cl = (v0 + i) / vpc;  // the channel within the group
      const int end = min(hi, (cl + 1) * vpc - v0);
      const float gam = __ldg(gamma + g * cgs + cl);
      const float bet = __ldg(beta + g * cgs + cl);
      float p = 0.f, pq = 0.f;
      for (int j = i + lane; j < end; j += 32) {
        const int4 rx = bx[j], rg = bg[j];
        const T* ex = reinterpret_cast<const T*>(&rx);
        const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xh = (to_f<T>(ex[k]) - mean) * rstd;
          const float dz = swish_grad(xh * gam + bet, to_f<T>(eg[k]));
          p += dz;
          pq += dz * xh;
        }
      }
      p = warp_sum(p);
      pq = warp_sum(pq);
      if (lane == 0) wpart[warp][cl] = make_float2(p, pq);
      i = end;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cgs; c += blockDim.x) {
    float2 a = make_float2(0.f, 0.f);
    for (int w = 0; w < nw; ++w) {  // warp order
      a.x += wpart[w][c].x;
      a.y += wpart[w][c].y;
    }
    pch[c] = a;
  }
  cluster.sync();
  // every rank: each channel's sums over the ranks in rank order, then the
  // group terms (the same arithmetic on every rank, so the same values)
  if (warp == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = lane; c < cgs; c += 32) {
      float P = 0.f, Q = 0.f;
      for (int r = 0; r < S; ++r) {
        const float2 v = cluster.map_shared_rank(pch, r)[c];
        P += v.x;
        Q += v.y;
      }
      const float gam = __ldg(gamma + g * cgs + c);
      t1 += gam * P;
      t2 += gam * Q;
      if (rank == 0 && pdz != nullptr) {
        pdz[bc0 + c] = P;
        pdzx[bc0 + c] = Q;
      }
    }
    t1 = warp_sum(t1);
    t2 = warp_sum(t2);
    if (lane == 0) {
      const float count = (float)((int64_t)hw * cgs);
      stat[3] = t1 / count;
      stat[4] = stat[2] * (t2 / count);
    }
  }
  // the others may leave once every CTA has read the partials
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (dx != nullptr) {
    const float m1 = stat[3], m2 = stat[4];
    int4* pd = reinterpret_cast<int4*>(dx + base) + v0;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const int c = g * cgs + (v0 + i) / vpc;
      const float gam = __ldg(gamma + c), bet = __ldg(beta + c);
      const int4 rx = bx[i], rg = bg[i];
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
      int4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xh = (to_f<T>(ex[k]) - mean) * rstd;
        const float dz = swish_grad(xh * gam + bet, to_f<T>(eg[k]));
        eo[k] = from_f<T>(rstd * (dz * gam - m1 - xh * m2));
      }
      pd[i] = out;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
cudaError_t launch_bwd_onepass(const void* x, const void* gy,
                               const void* gamma, const void* beta, void* dx,
                               void* pdz, void* pdzx, int groups, int C,
                               int G, int hw, int n, float eps, int cluster,
                               int threads, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_bwd_onepass_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdMaxShareBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int share = (n + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)share * 32;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, gn_bwd_onepass_kernel<T>, static_cast<const T*>(x),
      static_cast<const T*>(gy), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(dx),
      static_cast<float*>(pdz), static_cast<float*>(pdzx), C, G, hw, n,
      share, eps);
}

int vector_ok(const void* p, int64_t hw, int elem_bytes) {
  return (hw % (16 / elem_bytes)) == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch_onepass(const void* x, const void* gamma,
                           const void* beta, void* y, int groups, int C,
                           int G, int hw, int n, float eps, int cluster,
                           int threads, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_swish_onepass_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShareBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int share = (n + cluster - 1) / cluster;  // vectors, at most
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)share * 16;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_swish_onepass_kernel<T>,
                            static_cast<const T*>(x),
                            static_cast<const float*>(gamma),
                            static_cast<const float*>(beta),
                            static_cast<T*>(y), C, G, hw, n, eps);
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
// x, y: [B, C, hw]; sum, sumsq: [B, C] fp32 over `count` values per
// channel (hw, or the whole image's H*W where x is a band of its rows and
// the moments were summed over the bands); gamma, beta: [C] fp32.
int sr3d_gn_swish_apply(const void* x, const void* sum, const void* sumsq,
                        const void* gamma, const void* beta, void* y,
                        int64_t batch, int C, int G, int64_t hw,
                        int64_t count, float eps, int is_bf16,
                        void* stream) {
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
        G, hw, count, eps, vec);
  } else {
    gn_swish_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(sum),
        static_cast<const float*>(sumsq), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(y), C, G, hw,
        count, eps, vec);
  }
  return (int)cudaGetLastError();
}

// y = swish(groupnorm(x) * gamma + beta) in one launch, x read once.
// x, y: [B, C, hw], 16-byte aligned, hw a multiple of the 16-byte vector;
// gamma, beta: [C] fp32.  cluster (1, 2, 4, 8) and threads (a multiple of
// 32, <= 256) come from gn_plan; a rank's share of a group is at most
// 64 KB.  Returns the launch's cudaError_t.
int sr3d_gn_swish_onepass(const void* x, const void* gamma, const void* beta,
                          void* y, int batch, int C, int G, int hw, float eps,
                          int cluster, int threads, int is_bf16,
                          void* stream) {
  const int N = is_bf16 ? 8 : 4;
  if (batch < 1 || G < 1 || C % G || hw < 1 || hw % N ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      threads < 32 || threads > 256 || threads % 32 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)(C / G) * hw / N;
  if ((n + cluster - 1) / cluster * 16 > kMaxShareBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_onepass<__nv_bfloat16>(x, gamma, beta, y, batch * G,
                                              C, G, hw, (int)n, eps, cluster,
                                              threads, s)
              : launch_onepass<float>(x, gamma, beta, y, batch * G, C, G, hw,
                                      (int)n, eps, cluster, threads, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The backward of y = swish(groupnorm(x) * gamma + beta) in one launch, x
// and gy read once.  x, gy, dx: [B, C, hw], 16-byte aligned, hw a multiple
// of the 16-byte vector; gamma, beta: [C] fp32.  Writes dx (if not null)
// and pdz, pdzx: [B, C] fp32 sums of dz and dz * xhat over hw (if not
// null).  cluster (1, 2, 4, 8) and threads (a multiple of 32, <= 256) come
// from gn_bwd_plan; a rank's x + gy share is at most 192 KB and a group at
// most 64 channels.  Returns the launch's cudaError_t.
int sr3d_gn_swish_bwd_onepass(const void* x, const void* gy,
                              const void* gamma, const void* beta, void* dx,
                              void* pdz, void* pdzx, int batch, int C, int G,
                              int hw, float eps, int cluster, int threads,
                              int is_bf16, void* stream) {
  const int N = is_bf16 ? 8 : 4;
  if (batch < 1 || G < 1 || C % G || C / G > kBwdMaxCg || hw < 1 ||
      hw % N ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      threads < 32 || threads > 256 || threads % 32 ||
      ((pdz == nullptr) != (pdzx == nullptr)) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gy) |
        reinterpret_cast<uintptr_t>(dx)) &
       15))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)(C / G) * hw / N;
  if ((n + cluster - 1) / cluster * 32 > kBwdMaxShareBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_bwd_onepass<__nv_bfloat16>(
                    x, gy, gamma, beta, dx, pdz, pdzx, batch * G, C, G, hw,
                    (int)n, eps, cluster, threads, s)
              : launch_bwd_onepass<float>(x, gy, gamma, beta, dx, pdz, pdzx,
                                          batch * G, C, G, hw, (int)n, eps,
                                          cluster, threads, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The multi-pass backward's second pass (after sr3d_gn_stats): pdz, pdzx
// [B, C] fp32 = the sums of dz and dz * xhat over each (b, c) plane.
// x, gy: [B, C, hw]; sum, sumsq: sr3d_gn_stats's moments.
int sr3d_gn_swish_bwd_reduce(const void* x, const void* gy, const void* sum,
                             const void* sumsq, const void* gamma,
                             const void* beta, void* pdz, void* pdzx,
                             int64_t batch, int C, int G, int64_t hw,
                             float eps, int is_bf16, void* stream) {
  if (batch < 1 || G < 1 || C % G || hw < 1)
    return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4;
  const int vec = vector_ok(x, hw, elem) && vector_ok(gy, hw, elem);
  const int64_t work = vec ? hw / (16 / elem) : hw;
  int threads = kThreads;
  if (work < kThreads) threads = (int)((work + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned planes = (unsigned)(batch * C);
  if (is_bf16) {
    gn_bwd_reduce_kernel<__nv_bfloat16><<<planes, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gy), static_cast<const float*>(sum),
        static_cast<const float*>(sumsq), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(pdz),
        static_cast<float*>(pdzx), C, G, hw, eps, vec);
  } else {
    gn_bwd_reduce_kernel<float><<<planes, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gy),
        static_cast<const float*>(sum), static_cast<const float*>(sumsq),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<float*>(pdz), static_cast<float*>(pdzx), C, G, hw, eps,
        vec);
  }
  return (int)cudaGetLastError();
}

// The multi-pass backward's last pass: dx [B, C, hw] in x's type from x,
// gy, the moments and the sums of sr3d_gn_swish_bwd_reduce.
int sr3d_gn_swish_bwd_dx(const void* x, const void* gy, const void* sum,
                         const void* sumsq, const void* gamma,
                         const void* beta, const void* pdz, const void* pdzx,
                         void* dx, int64_t batch, int C, int G, int64_t hw,
                         float eps, int is_bf16, void* stream) {
  if (batch < 1 || G < 1 || C % G || hw < 1)
    return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4;
  const int vec = vector_ok(x, hw, elem) && vector_ok(gy, hw, elem) &&
                  vector_ok(dx, hw, elem);
  const int64_t chunk = (int64_t)kThreads * (16 / elem) * kApplyIters;
  dim3 grid((unsigned)(batch * C), (unsigned)((hw + chunk - 1) / chunk));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gn_bwd_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gy), static_cast<const float*>(sum),
        static_cast<const float*>(sumsq), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(pdz),
        static_cast<const float*>(pdzx), static_cast<__nv_bfloat16*>(dx), C,
        G, hw, eps, vec);
  } else {
    gn_bwd_dx_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gy),
        static_cast<const float*>(sum), static_cast<const float*>(sumsq),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const float*>(pdz), static_cast<const float*>(pdzx),
        static_cast<float*>(dx), C, G, hw, eps, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
