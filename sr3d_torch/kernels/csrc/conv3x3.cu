// 3x3 stride-1 SAME convolution for Hopper (sm_90a), plain and with a fused
// GroupNorm -> Swish prologue.
//
// Replaces two TPU kernels:
//   * conv3x3_pallas (_conv_kernel) of sr3d_tpu/kernels/conv3x3.py: nine
//     shifted [Ht*W, C] x [C, O] products over halo-DMA'd row bands, fp32
//     accumulation, no bias  ->  conv3x3_kernel<T, false>;
//   * fused_gn_swish_conv3x3 (_fused_kernel) of
//     sr3d_tpu/kernels/fused_block.py: swish(GN affine(x)) applied to each
//     input band in registers, the out-of-image halo zeroed AFTER the
//     activation (SAME pads the activation, not x), h rounded to x's type,
//     then the same conv plus bias  ->  conv3x3_kernel<T, true>.  Its GN
//     statistics come from gn_stats_nhwc_kernel (groupnorm_swish.cu).
//
// Layout: the JAX package's.  x [B, H, W, C] NHWC, w [3, 3, C, O] HWIO, out
// [B, H, W, O].  Seen as a GEMM this is the implicit-GEMM layout: M = B*H*W
// output pixels, N = O, K = 9*C with the C of one tap contiguous in both x
// and w, so w is already the [K, N] row-major matrix.
//
// What bounds it on an H100: operations.  At the 16->128 UNet's shapes, e.g.
// x [8, 128, 128, 128] -> 128 bf16, it does 2*M*N*K = 38.7 GFLOP against
// 67 MB of traffic: ~39 us at the 989 TF/s bf16 tensor-core rate, ~20 us of
// HBM time.  Only the tensor cores reach that rate.
//
// Design (a first version that is right, not yet fast):
//   * One block of 256 threads per 64-pixel x 64-output tile; each thread
//     keeps a 4 x 4 fp32 accumulator in registers.
//   * K is walked tap by tap (dy, dx), and within a tap in chunks of 16
//     channels.  Each chunk stages a [16 x 64] A tile (the shifted input
//     pixels, gathered from NHWC with the out-of-image taps and the
//     channels past C masked to zero) and a [16 x 64] B tile of w in shared
//     memory as fp32, then every thread does 16 x 16 FMAs.
//   * The fused prologue is applied while the A tile is loaded:
//     h = (x - mean) * (rstd * gamma) + beta, swish, rounded to x's type.
//     (x - mean) is taken first, as the port's GN kernel does, not folded
//     into a shift (beta - mean * a): that form cancels on near-constant
//     maps with a large mean.  It is recomputed once per tap and output
//     tile, 9 * ceil(O/64) times per input element.
//   * CUDA-core fp32 FMAs, no tensor cores: at most 67 TF/s.  mma.sync /
//     wgmma with TMA-fed stages is later work.
//   * Any C, O, H, W: ragged tiles are masked (C = 6 at conv_in).

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

}  // namespace

extern "C" {

// out = conv3x3_same(x, w) (+ bias).  x [B, H, W, C], w [3, 3, C, O] in
// x's type, bias [O] fp32 or null, out [B, H, W, O].  is_bf16: 1 for
// bfloat16, 0 for float32.  Returns cudaGetLastError().
int sr3d_conv3x3(const void* x, const void* w, const void* bias, void* out,
                 int B, int H, int W, int C, int O, int is_bf16,
                 void* stream) {
  return launch<false>(x, w, bias, nullptr, nullptr, nullptr, out, B, H, W,
                       C, O, is_bf16, stream);
}

// out = conv3x3_same(swish((x - mean) * scale + beta), w) + bias, the
// activation rounded to x's type.  mean, scale: [B, C] fp32; beta, bias
// fp32.  Returns cudaGetLastError().
int sr3d_fused_gn_swish_conv3x3(const void* x, const void* mean,
                                const void* scale, const void* beta,
                                const void* w, const void* bias, void* out,
                                int B, int H, int W, int C, int O,
                                int is_bf16, void* stream) {
  return launch<true>(x, w, bias, mean, scale, beta, out, B, H, W, C, O,
                      is_bf16, stream);
}

}  // extern "C"
