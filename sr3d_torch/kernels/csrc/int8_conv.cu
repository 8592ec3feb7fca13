// w8a8 int8 3x3 convolution (implicit GEMM) for Hopper (sm_90a).
//
// Replaces int8_conv of sr3d_tpu/ops/quant.py:42-82, which quantizes the
// activations per tensor and the weights per output channel, runs
// lax.conv_general_dilated(int8, int8 -> int32) and dequantizes in fp32.
// That is no Pallas kernel, but eager PyTorch has no CUDA int8 convolution:
// the only library route is im2col + torch._int_mm, which writes nine times
// the activations to memory.
//
// out[b, n, ho, wo] = float(sum_k xq[m, k] * wq[n, k]) * (a_scale * w_scale[n])
//                     + bias[n]
// with m = (b, ho, wo), k = (kh, kw, cin), stride 1 or 2, padding 1, and
//   xq = clip(round_half_even(x / a_scale), -127, 127)   (x in bf16 or fp32)
// quantized here, as each activation is loaded.  The weights arrive
// quantized (the wrapper derives wq and w_scale from the fp32 weights with
// torch ops, at every call as the JAX package does), laid out
// [Cout][3][3][Cin rounded up to 32], zero past Cin.
//
// Bit for bit with the plain version (kernels/int8_conv.py):
//   * the quantize is an IEEE division (__fdiv_rn, never a reciprocal or
//     __fdividef) and __float2int_rn, which rounds half to even as
//     torch.round and jnp.round do;
//   * the products are int8 x int8 -> int32 on the tensor cores, whose sums
//     are exact whatever their order (|sum| < 127^2 * 9 Cin < 2^31; the
//     wrapper refuses a Cin above that);
//   * the epilogue is int32 -> fp32 (__int2float_rn: the sums pass 2^24),
//     then a_scale * w_scale[n], the product, the bias, each rounded on its
//     own (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into one FMA),
//     then one rounding to the output type.
//
// What bounds it on an H100: at the widest serving input, [8, 192, 128,
// 128] bf16 -> 64 channels, stride 1, it must read 50 MB and write 17 MB
// (0.020 ms at 3.35 TB/s) and do 2.9e10 int8 operations (0.015 ms at 1979
// TOPS): bytes.  The design is the simple one, right first:
//   * one CTA of 4 warps per 64 output pixels x 64 output channels; the 64
//     pixels are R rows x TW columns of one image (TW the largest power of
//     two <= min(64, Wo)), so narrow deep levels still fill the tile;
//   * for each chunk of 32 input channels the CTA loads the input patch its
//     pixels need, ((R-1) s + 3) x ((TW-1) s + 3) pixels, each element read
//     once a chunk and quantized on the way into shared memory (32 channels
//     of a pixel contiguous, pixel rows padded to 48 or 40 bytes so that the
//     fragment loads below hit 32 distinct banks), and the chunk's weights
//     for all nine taps;
//   * then nine k = 32 steps, one a tap, of mma.sync m16n8k32 s8 (IMMA)
//     read straight from the patch: a warp owns 32 pixels x 32 channels;
//   * the epilogue writes NCHW in the output type.
// No pipelining, no wgmma, no TMA: those, and the quantize fused into the
// GroupNorm+Swish that feeds most of these convs, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps: 2 x 2 over the 64 x 64 tile
constexpr int BM = 64;         // output pixels per CTA
constexpr int BN = 64;         // output channels per CTA
constexpr int KC = 32;         // input channels per chunk (one k32 step a tap)
constexpr int kWStride = 48;   // bytes per weight row in shared memory

// bytes per patch pixel in shared memory: the 32 channels plus padding that
// puts the 8 pixel rows of a fragment load on distinct banks
__host__ __device__ constexpr int patch_stride(int stride) {
  return stride == 1 ? 48 : 40;
}

__host__ __device__ constexpr int patch_bytes(int tw_log2, int stride) {
  const int tw = 1 << tw_log2, rows = BM >> tw_log2;
  const int pr = (rows - 1) * stride + 3, pc = (tw - 1) * stride + 3;
  return ((pr * pc * patch_stride(stride)) + 15) & ~15;
}

__host__ __device__ constexpr int smem_bytes(int tw_log2, int stride) {
  return patch_bytes(tw_log2, stride) + 9 * BN * kWStride;
}

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
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t quantize(float v, float scale) {
  int q = __float2int_rn(__fdiv_rn(v, scale));
  q = min(127, max(-127, q));
  return static_cast<uint32_t>(q) & 0xffu;
}

// d += a * b, m16n8k32, s8 operands, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    int8_conv3x3_kernel(const Tin* __restrict__ x,
                        const int8_t* __restrict__ wq,
                        const float* __restrict__ a_scale_p,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ bias,
                        Tout* __restrict__ out, int Cin, int H, int W,
                        int Cout, int Ho, int Wo, int stride, int tw_log2,
                        int kpad, int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tw = 1 << tw_log2, rows = BM >> tw_log2;
  const int pr_n = (rows - 1) * stride + 3, pc_n = (tw - 1) * stride + 3;
  const int np = pr_n * pc_n;
  const int ps = patch_stride(stride);
  unsigned char* sP = smem;
  unsigned char* sW = smem + patch_bytes(tw_log2, stride);

  int tile = blockIdx.x;
  const int tx = tile % tiles_w;
  tile /= tiles_w;
  const int ty = tile % tiles_h;
  const int b = tile / tiles_h;
  const int ho0 = ty * rows, wo0 = tx * tw;
  const int ih0 = ho0 * stride - 1, iw0 = wo0 * stride - 1;
  const int n0 = blockIdx.y * BN;
  const Tin* xb = x + (int64_t)b * Cin * H * W;
  const int64_t plane = (int64_t)H * W;
  const float a_scale = *a_scale_p;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  // byte offset in the patch of fragment row (m16 tile mt, half h): pixel
  // m = wm + 16 mt + 8 h + g at tap (0, 0)
  int abase[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + 16 * mt + 8 * h + g;
      abase[mt][h] = (((m >> tw_log2) * stride) * pc_n +
                      (m & (tw - 1)) * stride) * ps + 4 * t4;
    }

  int acc[2][4][4] = {};
  for (int c0 = 0; c0 < kpad; c0 += KC) {
    // the patch: one thread a pixel, its 32 channels loaded, quantized and
    // packed four to a word
    for (int p = tid; p < np; p += kThreads) {
      const int pr = p / pc_n, pc = p - pr * pc_n;
      const int ih = ih0 + pr, iw = iw0 + pc;
      const bool inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const Tin* src = xb + (int64_t)c0 * plane + (int64_t)ih * W + iw;
      uint32_t word[KC / 4];
#pragma unroll
      for (int j = 0; j < KC / 4; ++j) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * j + e;
          if (inside && c0 + c < Cin)
            w |= quantize(to_f<Tin>(src[c * plane]), a_scale) << (8 * e);
        }
        word[j] = w;
      }
      uint2* dst = reinterpret_cast<uint2*>(sP + p * ps);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
        dst[j] = make_uint2(word[2 * j], word[2 * j + 1]);
    }
    // the chunk's weights: row (tap, n) holds wq[n0 + n][tap][c0 .. c0 + 32)
    for (int i = tid; i < 9 * BN * 2; i += kThreads) {
      const int half = i & 1, r = i >> 1;
      const int tap = r / BN, n = r - tap * BN;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < Cout)
        v = *reinterpret_cast<const uint4*>(
            wq + ((int64_t)(n0 + n) * 9 + tap) * kpad + c0 + 16 * half);
      *reinterpret_cast<uint4*>(sW + r * kWStride + 16 * half) = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap - 3 * kh;
      const int toff = (kh * pc_n + kw) * ps;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = *reinterpret_cast<const uint32_t*>(sP + abase[mt][0] +
                                                      toff);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(sP + abase[mt][1] +
                                                      toff);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(sP + abase[mt][0] +
                                                      toff + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(sP + abase[mt][1] +
                                                      toff + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* wrow =
            sW + (tap * BN + wn + 8 * nt + g) * kWStride + 4 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wrow + 16);
        mma_s8(acc[0][nt], a[0], b0, b1);
        mma_s8(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();  // the patch and the weights are free for the next chunk
  }

  // ---- epilogue: dequantize, bias, NCHW store ------------------------------
  const int64_t oplane = (int64_t)Ho * Wo;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + 16 * mt + 8 * h + g;
      const int ho = ho0 + (m >> tw_log2), wo = wo0 + (m & (tw - 1));
      if (ho >= Ho || wo >= Wo) continue;
      Tout* dst = out + (int64_t)b * Cout * oplane + (int64_t)ho * Wo + wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * nt + 2 * t4 + e;
          if (n >= Cout) continue;
          float v = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]),
                              __fmul_rn(a_scale, w_scale[n]));
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          dst[n * oplane] = from_f<Tout>(v);
        }
    }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* wq, const void* a_scale,
           const void* w_scale, const void* bias, void* out, int batch,
           int Cin, int H, int W, int Cout, int stride, cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  int tw_log2 = 6;
  while (tw_log2 > 0 && (1 << tw_log2) > Wo) --tw_log2;
  const int rows = BM >> tw_log2;
  const int tiles_w = (Wo + (1 << tw_log2) - 1) >> tw_log2;
  const int tiles_h = (Ho + rows - 1) / rows;
  const int64_t tiles = (int64_t)batch * tiles_h * tiles_w;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + BN - 1) / BN));
  int8_conv3x3_kernel<Tin, Tout><<<grid, kThreads,
                                   smem_bytes(tw_log2, stride), s>>>(
      static_cast<const Tin*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<Tout*>(out), Cin, H, W,
      Cout, Ho, Wo, stride, tw_log2, (Cin + KC - 1) / KC * KC, tiles_h,
      tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [batch, Cin, H, W] contiguous, bf16 (in_bf16 = 1) or fp32; wq: int8
// [Cout][3][3][Cin rounded up to 32], 16-byte aligned, zero past Cin;
// a_scale: one fp32 on the device; w_scale: fp32 [Cout]; bias: fp32 [Cout]
// or null; out: [batch, Cout, Ho, Wo] contiguous, bf16 (out_bf16 = 1) or
// fp32, Ho = (H - 1) / stride + 1.  stride 1 or 2, padding 1.  Returns the
// launch's cudaError_t.
int sr3d_int8_conv3x3(const void* x, const void* wq, const void* a_scale,
                      const void* w_scale, const void* bias, void* out,
                      int batch, int Cin, int H, int W, int Cout, int stride,
                      int in_bf16, int out_bf16, void* stream) {
  if (batch < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 ||
      (stride != 1 && stride != 2) ||
      (reinterpret_cast<uintptr_t>(wq) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, wq, a_scale, w_scale, bias, out, batch, Cin, H, W, Cout, stride, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(x, wq, a_scale, w_scale, bias, out,
                                        batch, Cin, H, W, Cout, stride, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, wq, a_scale, w_scale, bias, out,
                                        batch, Cin, H, W, Cout, stride, s);
  return launch<float, float>(x, wq, a_scale, w_scale, bias, out, batch, Cin,
                              H, W, Cout, stride, s);
}

}  // extern "C"
