// Single-head spatial self-attention forward for Hopper (sm_90a).
//
// Replaces _attn_pallas (_attn_kernel) of sr3d_tpu/kernels/attention.py:
// out = softmax(Q K^T * scale) V over all HW tokens, q, k, v, out [B, HW, C],
// fp32 scores, max-subtracted softmax, the probabilities rounded to v's type
// before P V (as _attn_kernel does), fp32 accumulation, out in q's type.
// The scale is 1/sqrt(C) over the full channel count; the caller passes it.
// The full score rows stay on chip (no online softmax), so P is rounded
// exactly where the reference rounds it.
//
// What bounds it on an H100: at the 16->128 mid block, [8, 64, 512] bf16,
// it moves 2 MB (three reads and one write, ~0.6 us at 3.35 TB/s) and does
// 67 MFLOP (~0.07 us at the bf16 tensor-core peak).  Both are tiny: what
// sets the time is latency and how many SMs take part.  The head dim 512 is
// above PyTorch's flash-attention cap, which is why the port writes its own.
//
// Two kernels; the wrapper's plan (attn_plan in attention.py) picks one by
// dtype and shape, never by failure:
//
// attn_mma_kernel: bf16, C a multiple of 8, HW <= 256.  Tensor cores over a
// thread-block cluster.
//   * Grid: one CTA per (64-channel slice, 64-query tile, image).  The
//     S = min(8, ceil(C/64)) CTAs of one (query tile, image) form a
//     cluster; rank r owns slices r, r + S, ...  [8, 64, 512]: 64 CTAs in
//     8 clusters of 8 (the first port: 32 blocks); B = 1: 8 CTAs (4).
//   * Loads: each CTA copies only its slices of Q, K and V into shared
//     memory, 16 bytes a thread with cp.async (zero fill past HW and C), so
//     each input byte leaves HBM once.  Rows are padded to 144 bytes, which
//     makes every ldmatrix below free of bank conflicts.
//   * Scores: 8 warps; warp w takes 16 query rows and every other 16-key
//     step of the partial Q_s K_s^T over the CTA's channels with mma.sync
//     m16n8k16 (bf16 in, fp32 accumulators; fragments by ldmatrix.x4).
//     The partial, 64 x HWp fp32 (HWp = HW rounded up to 16), goes to
//     shared memory; a CTA with several slices adds them in slice order.
//   * Reduction: after a cluster barrier, rank r owns query rows
//     [64 r / S, 64 (r + 1) / S).  For each of them a warp loads the S
//     partials through distributed shared memory, all of a row's loads in
//     flight at once (one DSMEM latency a row, not S x 8 in a chain as in
//     a first version, which with 4 warps and a gather of P took 0.013 ms
//     at [8, 64, 512]), adds them in rank order (no atomics: repeats are
//     bit-equal), scales, and runs the max-subtracted softmax in fp32 in
//     registers (8 columns a lane).
//   * Exchange: the row of P, rounded to bf16, is stored straight into
//     every rank's shared memory (DSMEM stores do not wait), so after a
//     second cluster barrier each CTA holds the full 64 x HWp P and none
//     touches another's memory again.
//   * Output: warp w computes 16 rows x 32 of the CTA's 64 channels of
//     P V_s with mma.sync (V fragments by ldmatrix.trans), stored in bf16.
//   * Ragged tiles: query rows past HW are zero and never stored; keys past
//     HW get no probability (P = 0, V rows zero); channels past C are zero
//     in Q, K and V and never stored.
//
// attn_fwd_kernel<T>: fp32 (tensor cores would mean TF32) and bf16 with C
// not a multiple of 8: the first port, CUDA-core fp32 FMAs.  One block per
// (16 query rows, image), the 16 x HW score rows in shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHW = 256;  // score rows held in shared memory

// ---- the tensor-core kernel ---------------------------------------------
constexpr int kMmaThreads = 256;  // 8 warps: 4 x 16 query rows, 2 halves
constexpr int QT = 64;            // query rows per CTA
constexpr int CS = 64;            // channels per slice
constexpr int LDT = CS + 8;       // bf16 row stride of the Q, K, V slices
constexpr int kMaxCluster = 8;

__host__ __device__ constexpr int padded_hw(int hw) { return (hw + 15) & ~15; }

__host__ __device__ constexpr size_t mma_smem_bytes(int hw) {
  // Q, K, V slices and P in bf16, the partial scores in fp32
  return (size_t)(QT * LDT + 2 * padded_hw(hw) * LDT +
                  QT * (padded_hw(hw) + 8)) * 2 +
         (size_t)QT * (padded_hw(hw) + 8) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows [row0, row0 + rows) x channels [c0, c0 + 64) of an [hw, C] matrix
// into a [rows][LDT] tile, zeros past hw and C (C % 8 == 0)
__device__ __forceinline__ void load_slice(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int row0,
                                           int rows, int hw, int C, int c0) {
  for (int i = threadIdx.x; i < rows * (CS / 8); i += kMmaThreads) {
    const int r = i / (CS / 8), c = (i % (CS / 8)) * 8;
    const bool ok = row0 + r < hw && c0 + c < C;
    cp_async16(dst + r * LDT + c,
               ok ? src + (int64_t)(row0 + r) * C + c0 + c : src, ok);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int hw, int C,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int hwp = padded_hw(hw);
  const int ldp = hwp + 8;  // row stride of P (bf16) and the scores (fp32)
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + QT * LDT;
  __nv_bfloat16* sV = sK + hwp * LDT;
  __nv_bfloat16* sP = sV + hwp * LDT;
  float* sS = reinterpret_cast<float*>(sP + QT * ldp);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.y * QT;
  const int64_t base = (int64_t)blockIdx.z * hw * C;
  const int nslices = (C + CS - 1) / CS;
  const bool one_slice = nslices == S;  // V can load with Q and K

  // ---- partial scores over this CTA's channel slices ----------------------
  // warp w: query rows 16 (w % 4) .., every other 16-key step from 16 (w / 4)
  const int wr = (warp & 3) * 16, half = warp >> 2;
  for (int sl = rank; sl < nslices; sl += S) {
    const int c0 = sl * CS;
    load_slice(sQ, q + base, q0, QT, hw, C, c0);
    load_slice(sK, k + base, 0, hwp, hw, C, c0);
    if (one_slice) load_slice(sV, v + base, 0, hwp, hw, C, c0);
    cp_async_wait_all();
    __syncthreads();
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4(a[ks],
                  sQ + (wr + (lane & 15)) * LDT + ks * 16 + (lane >> 4) * 8);
    for (int n0 = half * 16; n0 < hwp; n0 += 32) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDT +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[0], a[ks], b[0], b[1]);
        mma_bf16(acc[1], a[ks], b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float2* p0 = reinterpret_cast<float2*>(sS + (wr + g) * ldp + n0 +
                                               j * 8 + 2 * t4);
        float2* p1 = reinterpret_cast<float2*>(
            reinterpret_cast<float*>(p0) + 8 * ldp);
        float2 lo = make_float2(acc[j][0], acc[j][1]);
        float2 hi = make_float2(acc[j][2], acc[j][3]);
        if (sl != rank) {  // a later slice of this CTA: add in slice order
          lo.x += p0->x, lo.y += p0->y;
          hi.x += p1->x, hi.y += p1->y;
        }
        *p0 = lo;
        *p1 = hi;
      }
    }
    __syncthreads();  // sQ, sK free for the next slice
  }

  // ---- this rank's rows: the cluster's partials in rank order, softmax,
  // ---- the row of P into every rank's shared memory -------------------------
  cluster.sync();
  const float* parts[kMaxCluster];
  __nv_bfloat16* peers[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    parts[r] = cluster.map_shared_rank(sS, r < S ? r : rank);
    peers[r] = cluster.map_shared_rank(sP, r < S ? r : rank);
  }
  const int r0 = rank * QT / S, r1 = (rank + 1) * QT / S;
  for (int row = r0 + warp; row < r1; row += kMmaThreads / 32) {
    // lane: columns 2 lane + 64 i and the next, i < 4; all S x 4 loads of
    // the row in flight at once, then added in rank order (x + 0 = x for
    // the ranks past S)
    float2 sc[kMaxHW / 64];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxHW / 64; ++i) {
      const int j = 2 * lane + 64 * i;
      float2 p[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        p[r] = r < S && j < hw
                   ? *reinterpret_cast<const float2*>(parts[r] + row * ldp + j)
                   : make_float2(0.f, 0.f);
      float2 acc = p[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) acc.x += p[r].x, acc.y += p[r].y;
      sc[i].x = j < hw ? acc.x * scale : -INFINITY;
      sc[i].y = j + 1 < hw ? acc.y * scale : -INFINITY;
      m = fmaxf(m, fmaxf(sc[i].x, sc[i].y));
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxHW / 64; ++i) {
      const int j = 2 * lane + 64 * i;
      sc[i].x = j < hw ? expf(sc[i].x - m) : 0.f;
      sc[i].y = j + 1 < hw ? expf(sc[i].y - m) : 0.f;
      sum += sc[i].x + sc[i].y;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < kMaxHW / 64; ++i) {
      const int j = 2 * lane + 64 * i;
      if (j >= hwp) continue;
      const __nv_bfloat162 pb =
          __floats2bfloat162_rn(sc[i].x / sum, sc[i].y / sum);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < S)
          *reinterpret_cast<__nv_bfloat162*>(peers[r] + row * ldp + j) = pb;
    }
  }
  cluster.sync();  // every rank's rows of P are here; no DSMEM access after

  // ---- out = P V_s for this CTA's slices ----------------------------------
  // warp w: query rows 16 (w % 4) .., channels 32 (w / 4) .. of the slice
  for (int sl = rank; sl < nslices; sl += S) {
    const int c0 = sl * CS;
    if (!one_slice) {
      load_slice(sV, v + base, 0, hwp, hw, C, c0);
      cp_async_wait_all();
      __syncthreads();
    }
    float acc[4][4] = {};
    for (int k0 = 0; k0 < hwp; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sP + (wr + (lane & 15)) * ldp + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      LDT +
                                 half * 32 + n * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * n], a, b[0], b[1]);
        mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
      }
    }
    const int row = q0 + wr + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = c0 + half * 32 + nt * 8 + 2 * t4;
      if (c >= C) continue;
      if (row < hw)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (int64_t)row * C +
                                           c) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      if (row + 8 < hw)
        *reinterpret_cast<__nv_bfloat162*>(out + base +
                                           (int64_t)(row + 8) * C + c) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();  // sV free for the next slice
  }
}

// ---- the CUDA-core kernel (fp32; bf16 with C % 8 != 0) ------------------
constexpr int kThreads = 256;
constexpr int TQ = 16;  // query rows per block
constexpr int TK = 64;  // keys per tile
constexpr int CK = 32;  // channel chunk of Q K^T
constexpr int CV = 64;  // channel chunk of P V

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int hw,
                    int C, float scale) {
  __shared__ float S[TQ][kMaxHW];
  __shared__ float sQ[TQ][CK + 1];
  __shared__ float sKV[TK * (CV + 1)];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int64_t base = (int64_t)blockIdx.y * hw * C;
  q += base;
  k += base;
  v += base;
  out += base;
  const int rows = min(TQ, hw - q0);

  // ---- scores S = Q K^T * scale -----------------------------------------
  for (int k0 = 0; k0 < hw; k0 += TK) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < C; c0 += CK) {
      for (int i = tid; i < TQ * CK; i += kThreads) {
        const int r = i / CK, c = i % CK;
        sQ[r][c] = (r < rows && c0 + c < C)
                       ? to_f<T>(q[(int64_t)(q0 + r) * C + c0 + c])
                       : 0.f;
      }
      for (int i = tid; i < TK * CK; i += kThreads) {
        const int j = i / CK, c = i % CK;
        sKV[j * (CK + 1) + c] = (k0 + j < hw && c0 + c < C)
                                    ? to_f<T>(k[(int64_t)(k0 + j) * C + c0 + c])
                                    : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * kThreads;
        const int r = idx / TK, kk = idx % TK;
#pragma unroll 8
        for (int c = 0; c < CK; ++c)
          acc[e] += sQ[r][c] * sKV[kk * (CK + 1) + c];
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / TK, kk = idx % TK;
      if (k0 + kk < hw) S[r][k0 + kk] = acc[e] * scale;
    }
  }
  __syncthreads();

  // ---- row softmax, probabilities rounded to T --------------------------
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float m = -INFINITY;
    for (int j = lane; j < hw; j += 32) m = fmaxf(m, S[r][j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < hw; j += 32) {
      const float e = expf(S[r][j] - m);
      S[r][j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < hw; j += 32)
      S[r][j] = to_f<T>(from_f<T>(S[r][j] / sum));
  }
  __syncthreads();

  // ---- out = P V --------------------------------------------------------
  for (int c0 = 0; c0 < C; c0 += CV) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < hw; k0 += TK) {
      for (int i = tid; i < TK * CV; i += kThreads) {
        const int j = i / CV, c = i % CV;
        sKV[j * CV + c] = (k0 + j < hw && c0 + c < C)
                              ? to_f<T>(v[(int64_t)(k0 + j) * C + c0 + c])
                              : 0.f;
      }
      __syncthreads();
      const int jmax = min(TK, hw - k0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * kThreads;
        const int r = idx / CV, c = idx % CV;
        for (int j = 0; j < jmax; ++j)
          acc[e] += S[r][k0 + j] * sKV[j * CV + c];
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / CV, c = idx % CV;
      if (r < rows && c0 + c < C)
        out[(int64_t)(q0 + r) * C + c0 + c] = from_f<T>(acc[e]);
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, out: [batch, hw, C], contiguous, 16-byte aligned for the
// tensor-core kernel; hw <= 256.  cluster: 0 runs the CUDA-core kernel
// (is_bf16: 1 for bfloat16, 0 for float32); 1..8 runs the tensor-core kernel
// (bf16, C % 8 == 0) with clusters of that many CTAs, which must be
// min(8, ceil(C / 64)).  Returns the launch's cudaError_t.
int sr3d_attention_fwd(const void* q, const void* k, const void* v, void* out,
                       int batch, int hw, int C, float scale, int is_bf16,
                       int cluster, void* stream) {
  if (hw > kMaxHW || hw < 1 || C < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    const int slices = (C + CS - 1) / CS;
    const int want = slices < kMaxCluster ? slices : kMaxCluster;
    if (!is_bf16 || C % 8 || cluster != want ||
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
         15))
      return (int)cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          attn_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)mma_smem_bytes(kMaxHW));
      if (e != cudaSuccess) return (int)e;
      smem_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster, (unsigned)((hw + QT - 1) / QT),
                       (unsigned)batch);
    cfg.blockDim = dim3(kMmaThreads);
    cfg.dynamicSmemBytes = mma_smem_bytes(hw);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, attn_mma_kernel, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), hw, C, scale);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  dim3 grid((unsigned)((hw + TQ - 1) / TQ), (unsigned)batch);
  if (is_bf16) {
    attn_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), hw, C, scale);
  } else {
    attn_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), hw, C, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
