// 3x3 stride-1 SAME convolution for Hopper (sm_90a), plain and with a fused
// GroupNorm -> Swish prologue.
//
// Replaces two TPU kernels:
//   * conv3x3_pallas (_conv_kernel) of sr3d_tpu/kernels/conv3x3.py: nine
//     shifted [Ht*W, C] x [C, O] products over halo-DMA'd row bands, fp32
//     accumulation, no bias;
//   * fused_gn_swish_conv3x3 (_fused_kernel) of
//     sr3d_tpu/kernels/fused_block.py: swish(GN affine(x)) applied to each
//     input band once, the out-of-image halo zeroed AFTER the activation
//     (SAME pads the activation, not x), h rounded to x's type, then the
//     same conv plus bias.  Its GN statistics come from
//     gn_stats_nhwc_kernel (groupnorm_swish.cu).
//
// Layout: the JAX package's.  x [B, H, W, C] NHWC, w [3, 3, C, O] HWIO, out
// [B, H, W, O].  As a GEMM: M = B*H*W output pixels, N = O, K = 9*C.
//
// What bounds it on an H100: operations.  x [8, 128, 128, 128] -> 128 bf16
// is 2*M*N*K = 38.7 GFLOP against 67 MB: ~39 us at the 989 TF/s bf16
// tensor-core rate, ~20 us of HBM time.  Only the tensor cores reach it.
//
// Two kernels; the wrapper's plan (conv_plan in conv3x3.py) picks one by
// shape and dtype, never by failure:
//
// conv3x3_wgmma_kernel<BN, kPrologue>: bf16, C % 64 == 0, O % 64 == 0.
//   * Tiles: BN = 128 outputs (64 where O % 128 != 0) by BM = 128 output
//     pixels (256 at BN = 64), so every weight tile feeds the same
//     128 x 256 x 64 products.  A tile is IMGS images x R rows x TW <= 128
//     columns: one row of 128 pixels at W = 128 (two at BN = 64), two whole
//     8x8 images at the deep level.  K is walked in 64-channel chunks
//     (128-byte rows), each chunk tap by tap.
//   * Persistent and warp-specialised, 512 threads, one block per SM over
//     the work items (tile, output columns, K split).  Warp 7 loads weight
//     tiles; thread 0 loads bands and warps 0-6 activate them; warps 8-15,
//     two warpgroups, run the products.  setmaxnreg moves registers from
//     the loaders (96, or 104 at BN = 64) to the products (160 / 152).
//   * The band: per chunk, input rows [h0-1, h0+R] x columns [w0-1, w0+TW]
//     of the tile's images arrive in shared memory as one 4-D TMA box of x
//     (cp.async.bulk.tensor, 128-byte swizzle); TMA writes zeros where the
//     box leaves the tensor, which is SAME's padding.  Two band buffers, so
//     the next chunk's band loads while this one's products run.
//   * The fused prologue: the activation warps apply (x - mean) * (rstd *
//     gamma) + beta, swish and the rounding to bf16 to every in-image
//     pixel of the band, in place, once, two pixels a step; the zeros
//     outside the image stay zero, after the activation.  (x - mean) is
//     kept apart, as in the GN kernel: the folded shift cancels on
//     near-constant maps with a large mean.  An input element is
//     activated (R+2)/R * ceil(O/BN) times: 2 at W = 128 with O = 64,
//     1.25 * 4 at the 8x8 level with O = 512 (the CUDA-core kernel: 9 *
//     ceil(O/64)).
//   * A from registers: the nine taps are nine row/column offsets into the
//     same band; ldmatrix.x4 at each lane's shifted pixel row gives
//     wgmma's register-A fragment.  At BN = 128 tap t+1's fragments load
//     while tap t's products run; at BN = 64 (two m64 products a
//     warpgroup) one tap's fragments are in flight, the two warpgroups
//     overlapping each other.
//   * B, the weights, read in place: w [3, 3, C, O] is the [9C, O] matrix
//     with N contiguous, so the weight tile is MN-major and wgmma reads it
//     transposed (imm-trans-b).  A ring of 4 stages of [64 x BN] tiles,
//     each BN/64 TMA boxes of 64 x 64.  Each product warp releases a stage
//     through an "empty" mbarrier once its group is done.  The tensor maps
//     come from libcuda's cuTensorMapEncodeTiled, taken through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//   * Split K for small M*N: with fewer output tiles than SMs the plan
//     splits the chunks as far as the SMs hold whole splits.  Each split
//     writes fp32 partials to a workspace; splitk_reduce_kernel sums them
//     in split order, adds the bias and rounds.  No atomics: results repeat
//     bit for bit.
//   * Epilogue: bias in fp32, rounded to bf16, staged per warpgroup
//     through shared memory (swizzled) and stored 16 bytes a thread.
//
// conv3x3_kernel<T, kPrologue> (CUDA-core fp32 FMAs, the first port): fp32
//   (tensor cores would mean TF32, other numbers) and the bf16 shapes the
//   tensor-core path cannot take (C = 6 at conv_in, ragged O).  64 x 64
//   tiles, K walked tap by tap in 16-channel chunks, the fused prologue
//   recomputed per tap and output tile, any C, O, H, W (ragged tiles
//   masked).

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // input channels per staged chunk
constexpr int kARows = kThreads / BK;  // pixel rows one A-load pass covers
constexpr int kBRows = kThreads / BN;  // K rows one B-load pass covers

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

// mean, scale: [B, C] fp32 (scale = rstd * gamma); beta: [C] fp32; all null
// unless kPrologue.  bias: [O] fp32 or null.
template <typename T, bool kPrologue>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ scale,
                   const float* __restrict__ beta, T* __restrict__ out,
                   int H, int W, int C, int O, int64_t M) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t hw = (int64_t)H * W;

  // A loader: this thread always loads channel a_k of pixel rows
  // a_row + i * kARows of the tile; decode their (b, h, w) once.
  const int a_k = tid % BK;
  const int a_row = tid / BK;
  int64_t a_b[BM / kARows];
  int a_h[BM / kARows], a_w[BM / kARows];
  bool a_ok[BM / kARows];
#pragma unroll
  for (int i = 0; i < BM / kARows; ++i) {
    const int64_t m = m0 + a_row + i * kARows;
    a_ok[i] = m < M;
    const int64_t mm = a_ok[i] ? m : 0;
    a_b[i] = mm / hw;
    const int64_t r = mm % hw;
    a_h[i] = (int)(r / W);
    a_w[i] = (int)(r % W);
  }
  // B loader: output channel b_n, K rows b_row + i * kBRows of the chunk.
  const int b_n = n0 + tid % BN;
  const int b_row = tid / BN;

  const int ty = tid / (BN / 4), tx = tid % (BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
      const int c = c0 + a_k;
#pragma unroll
      for (int i = 0; i < BM / kARows; ++i) {
        const int hh = a_h[i] + dy, ww = a_w[i] + dx;
        float v = 0.f;  // SAME padding: zero outside the image
        if (a_ok[i] && c < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          v = to_f<T>(x[((a_b[i] * H + hh) * W + ww) * C + c]);
          if (kPrologue) {
            const int64_t bc = a_b[i] * C + c;
            const float z = (v - mean[bc]) * scale[bc] + beta[c];
            v = to_f<T>(from_f<T>(z / (1.f + expf(-z))));
          }
        }
        As[a_k][a_row + i * kARows] = v;
      }
#pragma unroll
      for (int i = 0; i < BK / kBRows; ++i) {
        const int kk = b_row + i * kBRows;
        const int cc = c0 + kk;
        Bs[kk][tid % BN] =
            (cc < C && b_n < O) ? to_f<T>(w[((int64_t)tap * C + cc) * O + b_n])
                                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < O)
        out[m * O + n] = from_f<T>(acc[i][j] + (bias ? bias[n] : 0.f));
    }
  }
}

template <bool kPrologue>
int launch(const void* x, const void* w, const void* bias, const void* mean,
           const void* scale, const void* beta, void* out, int B, int H,
           int W, int C, int O, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(bias);
  const float* fm = static_cast<const float*>(mean);
  const float* fs = static_cast<const float*>(scale);
  const float* fbe = static_cast<const float*>(beta);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16, kPrologue><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), fb, fm, fs, fbe,
        static_cast<__nv_bfloat16*>(out), H, W, C, O, M);
  } else {
    conv3x3_kernel<float, kPrologue><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), fb, fm,
        fs, fbe, static_cast<float*>(out), H, W, C, O, M);
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Tensor-core path
// ---------------------------------------------------------------------------

// Roles by warp: 0-6 activate the row bands (thread 0 also loads them),
// 7 loads the weights, 8-15 (two warpgroups) run the products.  The two
// load warpgroups give registers to the two product warpgroups
// (setmaxnreg, TileShape's counts).
constexpr int kActThreads = 224;
constexpr int kTmaWarp = 7;
constexpr int kConsumerWarps = 8;
constexpr int kTcThreads = 512;
constexpr int kTcStages = 4;     // TMA ring of weight tiles
constexpr int kChunk = 64;       // channels per K chunk: 128-byte rows

// BN = 128: each consumer warpgroup owns 64 rows (BM = 128); BN = 64: 128
// rows as two m64 products (BM = 256), so one weight tile always feeds
// 128 x 256 x 64 multiply-adds.
template <int BN>
struct TileShape {
  static constexpr int MW = 128 / BN;
  static constexpr uint32_t kBTile = BN * 128;
  static constexpr int kStageBytes = 64 * MW * BN * 2;  // a warpgroup's
  // A fragments in flight: two taps' at MW = 1 (tap t+1 loads while tap t
  // multiplies), one at MW = 2, whose registers go to the loaders instead
  static constexpr int kABufs = MW == 1 ? 2 : 1;
  static constexpr int kLoadRegs = MW == 1 ? 96 : 104;
  static constexpr int kMathRegs = MW == 1 ? 160 : 152;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One [64 K x BN] weight tile of w seen as [9C, O] (N contiguous): rows k
// .. k+63, columns n .. n+BN-1, as BN/64 boxes of 64 x 64 with the 128-byte
// swizzle, 8 KB apart.
template <int BN>
__device__ __forceinline__ void tma_load_b(void* dst, const CUtensorMap* map,
                                           uint64_t* bar, int k, int n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(BN * 128)
      : "memory");
#pragma unroll
  for (int h = 0; h < BN / 64; ++h)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
            smem_u32(dst) + h * 8192),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(n + 64 * h), "r"(k)
        : "memory");
}

// One band: box {64 channels, TW+2 columns, R+2 rows, IMGS images} of x at
// (c0, w0-1, h0-1, b0); TMA writes zeros where the box leaves the tensor,
// which is SAME's padding.
__device__ __forceinline__ void tma_load_band(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int w,
                                              int h, int b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(w), "r"(h), "r"(b)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma descriptor of an MN-major B tile (transposed B, bf16) with the
// 128-byte swizzle TMA wrote: 64-column atoms 8 KB apart (leading byte
// offset), groups of 8 K rows 1024 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((8192ull >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier among the 128 threads of consumer warpgroup `wg` (ids 1, 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Keep the compiler from moving accumulator reads across the asynchronous
// products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, MN-major in
// shared memory).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128) += A (64 x 16) * B (16 x 128), as above.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The global pixel index m of tile pixel p, or -1 where p lies outside the
// tile's images (the ragged last tile, or R*TW*IMGS < BM).
__device__ __forceinline__ int64_t tile_pixel(int p, int b0, int h0, int w0,
                                              int B, int H, int W, int TW,
                                              int R, int IMGS) {
  const int i = p / (R * TW), rem = p % (R * TW);
  const int b = b0 + i, h = h0 + rem / TW, w = w0 + rem % TW;
  if (i >= IMGS || b >= B || h >= H || w >= W) return -1;
  return ((int64_t)b * H + h) * W + w;
}

// One work item: a tile of output pixels, BN outputs from n0, and the
// channel chunks [c_lo, c_hi) of one K split.
struct Work {
  int b0, h0, w0, n0, c_lo, c_hi, split;
};

__device__ __forceinline__ Work work_item(int item, int BN, int H, int W,
                                          int C, int O, int TW, int R,
                                          int IMGS, int splits) {
  Work k;
  const int chunks = C / kChunk, n_tiles = O / BN;
  k.split = item % splits;
  int t = item / splits;
  k.n0 = (t % n_tiles) * BN;
  t /= n_tiles;
  const int n_tw = (W + TW - 1) / TW, n_r = (H + R - 1) / R;
  k.w0 = (t % n_tw) * TW;
  t /= n_tw;
  k.h0 = (t % n_r) * R;
  k.b0 = (t / n_r) * IMGS;
  k.c_lo = k.split * chunks / splits;
  k.c_hi = (k.split + 1) * chunks / splits;
  return k;
}

// Warps 0-2, fused variant: activate the band that TMA brought, in place,
// once: h = swish((x - mean) * scale + beta) rounded to bf16, for every
// in-image pixel; the zeros TMA wrote outside the image stay zero, which
// pads the activation.  The band is IMGS x (R+2) x (TW+2) pixels of 128
// bytes; 16-byte group g of band pixel bp sits at (g ^ (bp & 7)), the
// 128-byte swizzle.  Thread t always takes channel group t & 7, columns
// t/8, t/8 + 12, ...
__device__ __forceinline__ void activate_band(
    uint8_t* band, const float* __restrict__ mean,
    const float* __restrict__ scale, const float* __restrict__ beta,
    const Work& k, int c, int B, int H, int W, int C, int TW, int R,
    int IMGS) {
  const int BW = TW + 2, BR = R + 2;
  const int g = threadIdx.x & 7, col0 = threadIdx.x >> 3;
  constexpr int kCols = kActThreads / 8;
  const int ch = c * kChunk + g * 8;
  float be[8], mu[8], sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) be[e] = __ldg(beta + ch + e);
  for (int i = 0; i < IMGS; ++i) {
    const int b = k.b0 + i;
    if (b >= B) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mu[e] = __ldg(mean + (int64_t)b * C + ch + e);
      sc[e] = __ldg(scale + (int64_t)b * C + ch + e);
    }
    for (int br = 0; br < BR; ++br) {
      const int h = k.h0 + br - 1;
      if (h < 0 || h >= H) continue;
      const int row = (i * BR + br) * BW;
      // two pixels a step, for independent chains in flight
      for (int bc0 = col0; bc0 < BW; bc0 += 2 * kCols) {
        uint4* p[2];
        uint4 v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int bc = bc0 + u * kCols, w = k.w0 + bc - 1;
          const int bp = row + bc;
          p[u] = bc < BW && w >= 0 && w < W
                     ? reinterpret_cast<uint4*>(band + bp * 128 +
                                                ((g ^ (bp & 7)) << 4))
                     : nullptr;
          if (p[u]) v[u] = *p[u];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (!p[u]) continue;
          __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            const float z0 = (f.x - mu[2 * e]) * sc[2 * e] + be[2 * e];
            const float z1 =
                (f.y - mu[2 * e + 1]) * sc[2 * e + 1] + be[2 * e + 1];
            h2[e] = __floats2bfloat162_rn(__fdividef(z0, 1.f + __expf(-z0)),
                                          __fdividef(z1, 1.f + __expf(-z1)));
          }
          *p[u] = v[u];
        }
      }
    }
  }
}

// A fragments of one tap: for each 64-row product mi and K step ks, the
// ldmatrix.x4 at this lane's shifted band pixel.
template <int MW>
__device__ __forceinline__ void load_a(uint32_t (&a)[MW][4][4],
                                       uint32_t band, const int (&centre)[MW],
                                       int shift, int khalf) {
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    int bp = centre[mi] + shift;
    // opaque to the compiler: recomputing the addresses per tap costs a
    // few integer ops, hoisting all 9 x MW x 4 of them costs registers
    asm volatile("" : "+r"(bp));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4(a[mi][ks],
                  band + bp * 128 + (((2 * ks + khalf) ^ (bp & 7)) << 4));
  }
}

// Persistent: block blockIdx.x takes work items blockIdx.x, +gridDim.x, ...
// of m_tiles x (O/BN) x splits.  mean, scale: [B, C] fp32 (scale = rstd *
// gamma); beta: [C]; null unless kPrologue.  bias: [O] fp32 or null.  ws:
// [splits, M, O] fp32 partials when splits > 1 (the bias is then added by
// splitk_reduce_kernel).
template <int BN, bool kPrologue>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap xmap,
                         const float* __restrict__ bias,
                         const float* __restrict__ mean,
                         const float* __restrict__ scale,
                         const float* __restrict__ beta,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ ws, int B, int H, int W, int C,
                         int O, int TW, int R, int IMGS, int splits,
                         int n_items) {
  using S = TileShape<BN>;
  constexpr int MW = S::MW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int BW = TW + 2, BR = R + 2;
  const uint32_t band_tx = IMGS * BR * BW * 128;
  const int band_bytes = (band_tx + 1023) & ~1023;  // swizzle-aligned
  uint8_t* sB = smem;  // kTcStages weight tiles, 1024-byte aligned
  uint8_t* bands = sB + kTcStages * S::kBTile;  // two band buffers
  uint8_t* staging = bands + 2 * band_bytes;    // two warpgroups' outputs
  uint64_t* b_full = reinterpret_cast<uint64_t*>(staging + 2 * S::kStageBytes);
  uint64_t* b_empty = b_full + kTcStages;
  uint64_t* band_raw = b_empty + kTcStages;  // TMA has written the band
  uint64_t* band_full = band_raw + 2;        // ... and it is activated
  uint64_t* band_empty = band_full + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&band_raw[s], 1);
      mbar_init(&band_full[s], kActThreads);
      mbar_init(&band_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A ring slot or band buffer is used for the u-th time with parity
  // (u / depth) & 1; a producer's first wait on "empty" passes at once.
  // Warpgroup 0 (loads) hands registers to the two consumer warpgroups;
  // the roles never reconverge, so the compiler can give each its count.
  if (warp < 8) {
    setmaxnreg_dec<S::kLoadRegs>();
    if (warp == kTmaWarp) {
      if (lane == 0) {
        int use = 0;
        for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
          const Work k = work_item(item, BN, H, W, C, O, TW, R, IMGS, splits);
          for (int c = k.c_lo; c < k.c_hi; ++c)
            for (int tap = 0; tap < 9; ++tap, ++use) {
              const int slot = use % kTcStages;
              mbar_wait(&b_empty[slot], ((use / kTcStages) & 1) ^ 1);
              tma_load_b<BN>(sB + slot * S::kBTile, &wmap, &b_full[slot],
                             tap * C + c * kChunk, k.n0);
            }
        }
      }
    } else {
      if (!kPrologue && tid > 0) return;
      int use = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Work k = work_item(item, BN, H, W, C, O, TW, R, IMGS, splits);
        for (int c = k.c_lo; c < k.c_hi; ++c, ++use) {
          const int bs = use & 1;
          uint8_t* band = bands + bs * band_bytes;
          if (tid == 0) {
            mbar_wait(&band_empty[bs], ((use >> 1) & 1) ^ 1);
            tma_load_band(band, &xmap, &band_raw[bs], c * kChunk, k.w0 - 1,
                          k.h0 - 1, k.b0, band_tx);
          }
          if (kPrologue) {
            mbar_wait(&band_raw[bs], (use >> 1) & 1);
            activate_band(band, mean, scale, beta, k, c, B, H, W, C, TW, R,
                          IMGS);
            mbar_arrive(&band_full[bs]);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<S::kMathRegs>();
    // Consumers.  This lane's A rows (ldmatrix.x4: lanes 0-7 / 8-15 / 16-23
    // / 24-31 give rows 0-7 / 8-15 / 0-7 / 8-15 of the warp's 16, channels
    // +0 / +0 / +8 / +8) and their band pixels at the centre tap.
    const int cw = warp - 8, wg = cw >> 2;
    const int khalf = lane >> 4;
    int centre[MW];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      const int p = wg * 64 * MW + mi * 64 + (cw & 3) * 16 + (lane & 7) +
                    ((lane >> 3) & 1) * 8;
      centre[mi] = BW + 1;  // a pixel outside the tile reads pixel 0's band
      if (p < IMGS * R * TW) {
        const int i = p / (R * TW), rem = p % (R * TW);
        centre[mi] = (i * BR + rem / TW + 1) * BW + rem % TW + 1;
      }
    }
    // Accumulator rows of this thread in product mi: lr and lr + 8 of the
    // warpgroup's, lr = mi*64 + (cw&3)*16 + lane/4; columns 8j + 2q, +1.
    const int q = lane & 3;
    uint8_t* stage = staging + wg * S::kStageBytes;
    int band_use = 0, b_use = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Work k = work_item(item, BN, H, W, C, O, TW, R, IMGS, splits);
      float acc[MW][BN / 2];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;

      for (int c = k.c_lo; c < k.c_hi; ++c, ++band_use) {
        const int bs = band_use & 1;
        mbar_wait(kPrologue ? &band_full[bs] : &band_raw[bs],
                  (band_use >> 1) & 1);
        const uint32_t band = smem_u32(bands + bs * band_bytes);
        constexpr int NA = S::kABufs;
        uint32_t a[NA][MW][4][4];
        load_a<MW>(a[0], band, centre, -BW - 1, khalf);
        // With two fragment buffers, tap t's products run while tap t+1's
        // fragments load, and the stage of tap t-1 is released once its
        // group is done; with one, tap t is waited for first.
#pragma unroll
        for (int tap = 0; tap < 9; ++tap, ++b_use) {
          const int slot = b_use % kTcStages;
          mbar_wait(&b_full[slot], (b_use / kTcStages) & 1);
          const uint64_t desc = sw128_mn_desc(sB + slot * S::kBTile);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
              // K step ks starts 16 rows (2048 bytes) further down
              if constexpr (BN == 128)
                wgmma_m64n128(acc[mi], a[tap % NA][mi][ks], desc + 128 * ks);
              else
                wgmma_m64n64(acc[mi], a[tap % NA][mi][ks], desc + 128 * ks);
            }
          wgmma_commit();
          wgmma_wait<NA - 1>();
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) fence_acc(acc[mi]);
          if (tap + 1 >= NA && lane == 0)
            mbar_arrive(&b_empty[(b_use + 1 - NA) % kTcStages]);
          if (tap < 8)
            load_a<MW>(a[(tap + 1) % NA], band, centre,
                       ((tap + 1) / 3 - 1) * BW + (tap + 1) % 3 - 1, khalf);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) fence_acc(acc[mi]);
        if (lane == 0) {
          if (NA == 2) mbar_arrive(&b_empty[(b_use - 1) % kTcStages]);
          mbar_arrive(&band_empty[bs]);
        }
      }

      if (splits > 1) {
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wg * 64 * MW + mi * 64 + (cw & 3) * 16 + (lane >> 2) +
                          8 * half;
            const int64_t m =
                tile_pixel(r, k.b0, k.h0, k.w0, B, H, W, TW, R, IMGS);
            if (m < 0) continue;
            float* dst =
                ws + ((int64_t)k.split * B * H * W + m) * O + k.n0 + 2 * q;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
                  acc[mi][4 * j + 2 * half], acc[mi][4 * j + 2 * half + 1]);
          }
        continue;
      }
      wg_sync(wg);  // the warpgroup's previous tile has left the staging
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = k.n0 + 8 * j + 2 * q;
        const float bb0 = bias ? bias[n] : 0.f, bb1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int lr = mi * 64 + (cw & 3) * 16 + (lane >> 2) + 8 * half;
            *reinterpret_cast<__nv_bfloat162*>(stage + lr * BN * 2 +
                                               ((j ^ (lr & 7)) << 4) + q * 4) =
                __floats2bfloat162_rn(acc[mi][4 * j + 2 * half] + bb0,
                                      acc[mi][4 * j + 2 * half + 1] + bb1);
          }
      }
      wg_sync(wg);
      for (int idx = tid & 127; idx < 64 * MW * (BN / 8); idx += 128) {
        const int lr = idx / (BN / 8), j = idx % (BN / 8);
        const int64_t m = tile_pixel(wg * 64 * MW + lr, k.b0, k.h0, k.w0, B, H,
                                     W, TW, R, IMGS);
        if (m >= 0)
          *reinterpret_cast<uint4*>(out + m * O + k.n0 + 8 * j) =
              *reinterpret_cast<const uint4*>(stage + lr * BN * 2 +
                                              ((j ^ (lr & 7)) << 4));
      }
    }
  }
}

// out = bf16(sum over s of ws[s] + bias), the splits summed in order; four
// consecutive outputs a thread (O % 64 == 0).
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ out,
                                     int splits, int64_t MO, int O) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MO) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int k = 1; k < splits; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(ws + k * MO + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  if (bias) {
    const float4 b = *reinterpret_cast<const float4*>(bias + i % O);
    s.x += b.x;
    s.y += b.y;
    s.z += b.z;
    s.w += b.w;
  }
  __nv_bfloat162 r[2] = {__floats2bfloat162_rn(s.x, s.y),
                         __floats2bfloat162_rn(s.z, s.w)};
  *reinterpret_cast<uint2*>(out + i) = *reinterpret_cast<uint2*>(r);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a 2-D bf16 [rows, cols] matrix (cols contiguous) or of
// x [B, H, W, C], read in boxes whose inner extent is 64 elements (128 B)
// with the 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  cuuint64_t strides[3];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kPrologue>
int launch_wgmma(const void* x, const void* w, const void* bias,
                 const void* mean, const void* scale, const void* beta,
                 void* out, void* ws, int B, int H, int W, int C, int O,
                 int TW, int R, int IMGS, int splits, int blocks,
                 cudaStream_t s) {
  using S = TileShape<BN>;
  auto kernel = conv3x3_wgmma_kernel<BN, kPrologue>;
  const size_t band = ((size_t)IMGS * (R + 2) * (TW + 2) * 128 + 1023) &
                      ~(size_t)1023;
  const size_t smem = 1024 + kTcStages * S::kBTile + 2 * band +
                      2 * S::kStageBytes + (2 * kTcStages + 6) * 8;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // a TMA box has at most 256 elements a dimension
  if (smem > 232448 || TW + 2 > 256 || R + 2 > 256 || IMGS > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[2] = {(cuuint64_t)O, (cuuint64_t)9 * C};
  const cuuint32_t wbox[2] = {64, kChunk};
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint32_t xbox[4] = {kChunk, (cuuint32_t)TW + 2, (cuuint32_t)R + 2,
                              (cuuint32_t)IMGS};
  if (!encode_map(&wmap, w, 2, wdims, wbox) ||
      !encode_map(&xmap, x, 4, xdims, xbox))
    return (int)cudaErrorNotSupported;
  const int64_t items = (int64_t)((B + IMGS - 1) / IMGS) * ((H + R - 1) / R) *
                        ((W + TW - 1) / TW) * (O / BN) * splits;
  if (items > (1 << 30)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(blocks < items ? blocks : items), kTcThreads, smem, s>>>(
      wmap, xmap, splits > 1 ? nullptr : static_cast<const float*>(bias),
      static_cast<const float*>(mean), static_cast<const float*>(scale),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), B, H, W, C, O, TW, R, IMGS, splits,
      (int)items);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t MO = (int64_t)B * H * W * O;
    splitk_reduce_kernel<<<(unsigned)((MO / 4 + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), splits, MO, O);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = conv3x3_same(x, w) (+ bias) on CUDA cores.  x [B, H, W, C], w [3,
// 3, C, O] in x's type, bias [O] fp32 or null, out [B, H, W, O].  is_bf16:
// 1 for bfloat16, 0 for float32.  Returns cudaGetLastError().
int sr3d_conv3x3(const void* x, const void* w, const void* bias, void* out,
                 int B, int H, int W, int C, int O, int is_bf16,
                 void* stream) {
  return launch<false>(x, w, bias, nullptr, nullptr, nullptr, out, B, H, W,
                       C, O, is_bf16, stream);
}

// out = conv3x3_same(swish((x - mean) * scale + beta), w) + bias on CUDA
// cores, the activation rounded to x's type.  mean, scale: [B, C] fp32;
// beta, bias fp32.  Returns cudaGetLastError().
int sr3d_fused_gn_swish_conv3x3(const void* x, const void* mean,
                                const void* scale, const void* beta,
                                const void* w, const void* bias, void* out,
                                int B, int H, int W, int C, int O,
                                int is_bf16, void* stream) {
  return launch<true>(x, w, bias, mean, scale, beta, out, B, H, W, C, O,
                      is_bf16, stream);
}

// The tensor-core kernel, bf16 only.  x, w, bias, out as for sr3d_conv3x3;
// mean/scale/beta as above when prologue is 1, else null; x and w 16-byte
// aligned (TMA).  Tile: IMGS images x R rows x TW columns
// (R*TW*IMGS <= 128 for BN 128, <= 256 for BN 64); splits > 1 needs ws,
// [splits, B*H*W, O] fp32; blocks: the persistent grid (the SM count).
// Returns a cudaError_t.
int sr3d_conv3x3_wgmma(const void* x, const void* w, const void* bias,
                       const void* mean, const void* scale, const void* beta,
                       void* out, void* ws, int B, int H, int W, int C, int O,
                       int TW, int R, int IMGS, int BN, int splits,
                       int blocks, int prologue, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < kChunk || C % kChunk || O % BN ||
      (BN != 64 && BN != 128) || TW < 1 || R < 1 || IMGS < 1 ||
      TW * R * IMGS > 128 * (128 / BN) || splits < 1 ||
      splits > C / kChunk || blocks < 1 ||
      (splits > 1) != (ws != nullptr) ||
      (prologue && (!mean || !scale || !beta)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SR3D_LAUNCH(BN_, P_)                                                \
  return launch_wgmma<BN_, P_>(x, w, bias, mean, scale, beta, out, ws, B, \
                               H, W, C, O, TW, R, IMGS, splits, blocks, s)
  if (BN == 128) {
    if (prologue) SR3D_LAUNCH(128, true);
    SR3D_LAUNCH(128, false);
  }
  if (prologue) SR3D_LAUNCH(64, true);
  SR3D_LAUNCH(64, false);
#undef SR3D_LAUNCH
}

}  // extern "C"
