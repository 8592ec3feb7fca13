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
// quantized (the wrapper derives wq and w_scale from the fp32 weights, and
// ops/quant.py::Int8Conv keeps them per weight version), laid out
// [Cout][3][3][Cin rounded up to 32], zero past Cin: K-major.
//
// Bit for bit with the plain version (kernels/int8_conv.py):
//   * the quantize rounds the IEEE quotient x / a_scale (__fdiv_rn) half to
//     even (__float2int_rn), as torch.round and jnp.round do; the
//     tensor-core path takes the product with the reciprocal first, divides
//     only where that product lies within 2^-12 of a half-integer, and
//     rounds in the FP32 adder, which gives the same integers
//     (quantize_fast);
//   * the products are int8 x int8 -> int32 on the tensor cores, whose sums
//     are exact whatever their order (|sum| < 127^2 * 9 Cin < 2^31; the
//     wrapper refuses a Cin above that), K splits included;
//   * the epilogue is int32 -> fp32 (__int2float_rn: the sums pass 2^24),
//     then a_scale * w_scale[n], the product, the bias, each rounded on its
//     own (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into one FMA),
//     then one rounding to the output type.
//
// What bounds it on an H100: bytes.  At the widest serving input, [8, 192,
// 128, 128] bf16 -> 64 channels, stride 1, it must read 50 MB and write
// 17 MB (0.020 ms at 3.35 TB/s) and do 2.9e10 int8 operations (0.015 ms at
// 1979 TOPS).  At the deep levels (16^2 and 8^2, M = B*Ho*Wo = 2048 or 512,
// K = 9 Cin up to 9216) the output tiles are too few to fill 132 SMs.
// What holds this kernel back is neither: it is quantizing the activations
// inside the conv, ~10 FP32/integer operations an element on the CUDA
// cores, each element of a tile's band once (1.3-1.6 times the input, the
// halo).  PERF.md has the numbers; the quantize fused into the GroupNorm
// that feeds most of these convs is the way past it.
//
// Three kernels; the wrapper's plan (int8_plan in int8_conv.py) picks one by
// shape, never by failure:
//
// int8_conv3x3_wgmma_kernel<Tin, Tout, BN, MW>: Cin % 64 == 0, O % 64 ==
//   0, a row of x a multiple of 16 bytes (all 27 distinct int8 convs of the
//   flagship UNet).  One CTA of 512 threads per (tile, K split).
//   * Tiles: BN = 128 output channels (64 where O % 128 != 0) by 128 * MW
//     output pixels (MW = 2 at BN = 64, stride 1): IMGS images x R rows x
//     TW columns, TW a power of two chosen for the fewest band pixels a
//     tile pixel (16 x 16 at 128^2, whole 8 x 8 images at the deepest
//     level).  K is walked in 64-channel chunks, each chunk tap by tap.
//   * Band loads by TMA (warp 6): per chunk, x as it lies (NCHW) arrives as
//     4-D boxes over (W, H, C, B), KS channels deep, RS of them in flight:
//     the tile's input rows and columns plus their halo, (R-1)s+3 rows at
//     stride s; TMA writes zeros where the box leaves the tensor, which is
//     the padding.  A box starts on a 16-byte boundary of W (a misaligned
//     start is an illegal instruction), so it begins up to 16 bytes left
//     of the halo and the taps' offsets shift by as much.
//   * Quantize once and transpose, on 14 warps: the six quantize warps and
//     the eight product warps (before each chunk's products) share each
//     stage, 7 : 9.  A unit is two pixels by 8 channels: read channel-major
//     from shared memory, quantized branch-free (quantize_fast), written
//     pixel-major, 64 int8 channels a pixel (80-byte rows: the 8 rows of an
//     ldmatrix fall on distinct banks), the K-major layout 8-bit wgmma
//     takes.  Only the columns some tap reads are quantized.  Two quantized
//     bands, so the quantize warps run a chunk ahead of the products.
//   * Products (warps 8-15, two warpgroups of 64 * MW rows):
//     wgmma.mma_async m64nBNk32 .s32.s8.s8, two k-steps a tap.  The nine
//     taps are row and column offsets into one band; ldmatrix.x4 at each
//     lane's shifted pixel row gives the register-A fragment.  B, the
//     packed weights, arrives through a TMA ring of 4 [BN x 64] stages
//     (warp 7; 64-byte swizzle), each released by an "empty" mbarrier.
//   * Split K over a cluster: with fewer tiles than SMs the plan splits the
//     chunks over the CTAs of a thread-block cluster (up to 8).  After the
//     main loop every CTA writes its int32 partial tile into its own shared
//     memory; after a cluster barrier, rank r sums its share of the tile
//     over all ranks' partials through distributed shared memory, in int32,
//     and dequantizes once.  One launch, no workspace, no atomics.
//   * Epilogue: the same pass stores 8 outputs along W a thread (16 bytes
//     in bf16), NCHW.
//   * Not persistent and no setmaxnreg: a persistent grid that overlaps a
//     tile's epilogue with the next tile gains nothing while the quantize
//     bounds the kernel.

// int8_conv3x3_kernel<Tin, Tout> (the first version, mma.sync m16n8k32 s8,
//   IMMA): every other shape (ragged channel counts, the tiny test UNets).
//   One CTA of 4 warps per 64 output pixels x 64 output channels; for each
//   chunk of 32 input channels it loads the input patch its pixels need,
//   each element read once a chunk and quantized on the way into shared
//   memory, and the chunk's weights for all nine taps; then nine k = 32
//   steps, one a tap, of mma.sync read straight from the patch; the
//   epilogue writes NCHW.

// int8_conv3x3_deep_kernel<Tin, Tout> (plan "deep"): Cin % 64 == 0, O % 64
//   == 0, a row of x that is no multiple of 16 bytes (no TMA box: the 4^2
//   and 2^2 levels of the 8->32 UNet in bf16) and whole output images of at
//   most 128 pixels.  What bounds these convs is the weights: at [8, 512,
//   4, 4] -> 512 the int8 weights are 2.36 MB against 0.26 MB of
//   activations and 0.6 GOP (0.78 us at 3.35 TB/s, 0.3 us at 1979 TOPS);
//   M = B * Ho * Wo is 128 or 32 rows.  So the kernel spreads the weight
//   stream over many SMs, and what is left is a chain of latencies:
//   * Tiles: every output pixel of IMGS whole images (<= 128, one or two
//     m64 products) by 64 output channels: O / 64 tiles a batch of images.
//   * K split: K is 9 Cin / 64 (tap, 64-channel chunk) units; a cluster of
//     up to 8 CTAs a tile shares them, chunk-major: 8 x 8 = 64 CTAs at B =
//     8, one an SM (16 clusters of 8 CTAs of 32 channels were one more than
//     the card co-schedules, and the last shared SMs).  Each CTA streams its
//     9 (18 at Cin 1024) [64 x 64] weight tiles through a TMA ring of 16
//     (64-byte swizzle), all in flight at once (warp 8).
//   * x without TMA: the 64 channels of a chunk are one contiguous run of
//     an image (NCHW), fetched by 16-byte cp.async (the next chunk's while
//     this one's products run), then quantized (quantize_fast) pixel-major
//     into a padded band (80-byte pixels; the halo is zeroed once), only the
//     chunks the split's units touch.
//   * Products: wgmma m64n64k32 .s32.s8.s8, A by ldmatrix.x4 at each lane's
//     shifted band pixel, as in the tensor-core kernel; one warpgroup where
//     the tile has at most 64 pixels.
//   * The splits' int32 partials are stored straight into the shared memory
//     of the rank that finishes their channels (exact in any order); after
//     one cluster barrier each rank sums and dequantizes its own.
//   A launch at [8, 512, 4, 4] takes ~10 us: 0.8 set-up, 0.5 x's load, 1.8
//   quantize, 2.3 for 9 taps, 2.0 push and barrier, 1.3 sum and store
//   (per-CTA globaltimer stamps; PERF.md).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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


// ---------------------------------------------------------------------------
// Tensor-core path: s8 wgmma fed by TMA
// ---------------------------------------------------------------------------

// Roles by warp: 0-5 quantize the bands, 6 loads the raw bands, 7 loads
// the weight tiles (one lane each), 8-15 (two warpgroups) run the products.
constexpr int kTcThreads = 512;
constexpr int kXformThreads = 192;   // warps 0-5
constexpr int kQuantThreads = 448;   // and the product warps: all quantize
constexpr int kXformShare = 7;       // sixteenths of the quantize, warps 0-5
constexpr int kRawWarp = 6;
constexpr int kWeightWarp = 7;
constexpr int kConsumerWarps = 8;
constexpr int kStages = 4;   // TMA ring of weight tiles, one tap each
constexpr int kChunk = 64;   // input channels per K chunk: 64-byte rows
constexpr int kPix = 80;     // bytes per pixel of a quantized band
constexpr int kSmemLimit = 232448;
constexpr int kMaxRawStages = 8;

// The tile and band geometry of one launch (int8_plan in int8_conv.py).
struct TcShape {
  int B, Cin, H, W, O, Ho, Wo, stride;
  int TW, R, IMGS, BR, BWp, KS, splits;
  int raw_stages;  // the ring of raw band stages, 2 to kMaxRawStages
  int n_tiles, tiles_w, tiles_h;
  int q_bytes, raw_bytes, pipe_bytes;
};

__host__ __device__ constexpr int align_up(int n, int a) {
  return (n + a - 1) / a * a;
}

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

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One raw band stage: box {BWp columns, BR rows, KS channels, IMGS images}
// of x at (w, h, c, b); TMA writes zeros where the box leaves the tensor,
// which is the conv's padding (quantize(0) = 0).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int w, int h,
                                            int c, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(w),
      "r"(h), "r"(c), "r"(b)
      : "memory");
}

// One weight tile: 64 bytes of K (one tap of a chunk) by BN rows of the
// [O][9 Cin] int8 matrix, 64-byte swizzle.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int k, int n) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(n)
      : "memory");
}

// wgmma descriptor of a K-major B tile with 64-byte rows and the 64-byte
// swizzle TMA wrote: groups of 8 rows 512 bytes apart (stride byte
// offset); the leading byte offset is unused for swizzled K-major tiles.
__device__ __forceinline__ uint64_t sw64_k_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((512ull >> 4) << 32) |
         (2ull << 62);
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

// Every thread of the CTA has left its role's main loop (barrier 2,
// reached from each role's own code).
__device__ __forceinline__ void all_roles_done() {
  asm volatile("barrier.sync 2, %0;\n" ::"n"(kTcThreads) : "memory");
}

// Keep the compiler from moving accumulator reads across the asynchronous
// products.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 64, s32) += A (64 x 32 s8, registers) * B (32 x 64 s8, K-major
// in shared memory).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, s32) += A (64 x 32) * B (32 x 128), as above.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 1.5 * 2^23: adding it to |y| < 2^22 rounds y to an integer, half to even,
// in the FP32 adder (the conversion unit runs at an eighth of its rate),
// and leaves that integer in the low mantissa bits.
constexpr float kRound = 12582912.f;

// The quantize, bit for bit as quantize() above: y = v * fl(1/a) is within
// 3 ulp-of-128 (< 2.3e-5) of the true quotient wherever |v/a| <= 128, so
// its rounding is the true division's unless y lies within 2^-12 of a
// half-integer, which sets bit `bit` of `tie` (quantize_exact then
// decides).  t = y + kRound holds rint(y) in its low bits for |y| < 2^22,
// and clipping that integer to +-127 gives the same bytes as clipping y
// for every y (a larger |y| lands past the clip on its side).  Returns the
// int8 in the low byte.
__device__ __forceinline__ uint32_t quantize_fast(float v, float r,
                                                  uint32_t& tie, int bit) {
  const float y = __fmul_rn(v, r);
  const float t = __fadd_rn(y, kRound);
  const float f = __fsub_rn(y, __fsub_rn(t, kRound));  // y - rint(y)
  tie |= (uint32_t)(fabsf(f) > 0.5f - 0x1p-12f) << bit;
  const int q = __float_as_int(t) - __float_as_int(kRound);
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xffu;
}

__device__ __forceinline__ uint32_t quantize_exact(float v, float a) {
  const float y = fminf(fmaxf(__fdiv_rn(v, a), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, kRound)) & 0xffu;
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p);
template <>
__device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load_pair<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// x / d for 0 <= x < 2^16 and 2 <= d < 2^16 by a multiply-high with
// ceil(2^32 / d), exact in that range (the error x (m d - 2^32) / 2^32 d
// stays below 1/d): the quantize's index arithmetic, at every unit.
struct FastDiv {
  uint32_t m;
  __device__ explicit FastDiv(int d) : m(0xffffffffu / (uint32_t)d + 1u) {}
  __device__ int operator()(int x) const {
    return (int)__umulhi((uint32_t)x, m);
  }
};

// One raw stage (KS channels of the band, channel-major as TMA wrote it)
// into the pixel-major int8 band, shared by the six quantize warps (the
// first kXformShare sixteenths of the units) and the eight product warps
// (the rest): thread `vt` of the `n` of its group.  A unit is
// two neighbouring pixels by 8 channels: all 16 elements are loaded, then
// quantized without a branch, each once, then the rare ties fixed, then 8
// bytes a pixel written at channel group `group0 + g`.  Only the columns
// some tap reads, [col0, col0 + cols) of each band row, are quantized: the
// rest is the 16-byte alignment of the box.
template <typename Tin>
__device__ __forceinline__ void quantize_stage(const Tin* __restrict__ raw,
                                               uint8_t* qb, int vt, int n,
                                               bool xform, int plane,
                                               int BWp, int band_rows,
                                               int col0, int cols,
                                               int groups, int group0, int KS,
                                               float a, float r) {
  const int p_lo = col0 >> 1, p_row = ((col0 + cols + 1) >> 1) - p_lo;
  const int pairs = band_rows * p_row, units = pairs * groups;
  const int split = units * kXformShare / 16;
  const FastDiv by_pairs(pairs), by_p_row(p_row), by_br(plane / BWp);
  for (int u = (xform ? 0 : split) + vt; u < (xform ? split : units);
       u += n) {
    const int g = by_pairs(u), pr = u - g * pairs;
    const int row = by_p_row(pr);
    const int px = row * BWp + 2 * (p_lo + pr - row * p_row);
    const int img = by_br(row), rem = px - img * plane;
    const Tin* src = raw + (int64_t)(img * KS + 8 * g) * plane + rem;
    float2 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = load_pair<Tin>(src + e * plane);
    uint32_t lo[2] = {0u, 0u}, hi[2] = {0u, 0u}, tie = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lo[e >> 2] |= quantize_fast(v[e].x, r, tie, 2 * e) << (8 * (e & 3));
      hi[e >> 2] |= quantize_fast(v[e].y, r, tie, 2 * e + 1) << (8 * (e & 3));
    }
    if (tie) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (tie & (3u << (2 * e))) {
          const int sh = 8 * (e & 3);
          lo[e >> 2] = (lo[e >> 2] & ~(0xffu << sh)) |
                       (quantize_exact(v[e].x, a) << sh);
          hi[e >> 2] = (hi[e >> 2] & ~(0xffu << sh)) |
                       (quantize_exact(v[e].y, a) << sh);
        }
    }
    const int off = (group0 + g) * 8;
    *reinterpret_cast<uint2*>(qb + px * kPix + off) = make_uint2(lo[0], lo[1]);
    *reinterpret_cast<uint2*>(qb + (px + 1) * kPix + off) =
        make_uint2(hi[0], hi[1]);
  }
}

// Every raw stage of one chunk into its quantized band (see quantize_stage);
// `raw_use` counts the raw stages this thread has taken.
template <typename Tin>
__device__ __forceinline__ void quantize_chunk(const TcShape& s,
                                               const uint8_t* raws,
                                               uint64_t* raw_full,
                                               uint64_t* raw_empty,
                                               uint8_t* qb, int vt, int n,
                                               bool xform, int& raw_use,
                                               int shift0, float a, float r) {
  const int groups = s.KS / 8;
  for (int sub = 0; sub < kChunk / s.KS; ++sub, ++raw_use) {
    const int rs = raw_use % s.raw_stages;
    mbar_wait(&raw_full[rs], (raw_use / s.raw_stages) & 1);
    quantize_stage<Tin>(reinterpret_cast<const Tin*>(raws + rs * s.raw_bytes),
                        qb, vt, n, xform, s.BR * s.BWp, s.BWp,
                        s.IMGS * s.BR, shift0,
                        (s.TW - 1) * s.stride + 3, groups, sub * groups, s.KS,
                        a, r);
    mbar_arrive(&raw_empty[rs]);
  }
}

// A fragments of one tap: for each 64-row product mi and k-step ks (32
// channels), the ldmatrix.x4 at this lane's shifted band pixel.
template <int MW>
__device__ __forceinline__ void load_a(uint32_t (&a)[MW][2][4], uint32_t qb,
                                       const int (&centre)[MW], int shift,
                                       int khalf) {
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    int bp = centre[mi] + shift;
    asm volatile("" : "+r"(bp));
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldmatrix_x4(a[mi][ks], qb + bp * kPix + ks * 32 + khalf * 16);
  }
}

// Tile pixel `pix` -> its output (b, ho, wo); false outside the output.
__device__ __forceinline__ bool out_pixel(const TcShape& s, int pix, int b0,
                                          int h0, int w0, int& b, int& ho,
                                          int& wo) {
  const int per = s.R * s.TW, i = pix / per, rem = pix - i * per;
  b = b0 + i;
  ho = h0 + rem / s.TW;
  wo = w0 + rem % s.TW;
  return i < s.IMGS && b < s.B && ho < s.Ho && wo < s.Wo;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* dst,
                                              const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float (&v)[8]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    h[e] = __halves2bfloat162(__float2bfloat16_rn(v[2 * e]),
                              __float2bfloat16_rn(v[2 * e + 1]));
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(h);
}

// The tile a CTA works on, decoded from its index (output channels fastest,
// so neighbouring CTAs share a band through L2), with the band's origin:
// the box starts at input column wb, on a 16-byte boundary, and the tile's
// first needed column sits `shift0` columns in.
struct Tile {
  int n0, w0, h0, b0, wb, shift0;
};

template <typename Tin, int BN>
__device__ __forceinline__ Tile decode_tile(const TcShape& s, int t) {
  constexpr int kAlignW = 16 / (int)sizeof(Tin);
  Tile k;
  k.n0 = (t % s.n_tiles) * BN;
  t /= s.n_tiles;
  k.w0 = (t % s.tiles_w) * s.TW;
  t /= s.tiles_w;
  k.h0 = (t % s.tiles_h) * s.R;
  k.b0 = (t / s.tiles_h) * s.IMGS;
  const int wneed = k.w0 * s.stride - 1;
  k.wb = wneed >= 0 ? wneed / kAlignW * kAlignW : -kAlignW;
  k.shift0 = wneed - k.wb;
  return k;
}

// One CTA per (tile, K split); the splits of a tile form one cluster.
// Shared memory: the weight ring, two quantized bands, the raw stages
// (after the main loop: the int32 partial tile), then the barriers.
template <typename Tin, typename Tout, int BN, int MW>
__global__ void __launch_bounds__(kTcThreads, 1)
    int8_conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const float* __restrict__ a_scale_p,
                              const float* __restrict__ w_scale,
                              const float* __restrict__ bias,
                              Tout* __restrict__ out, const TcShape s) {
  constexpr int BM = 128 * MW;
  constexpr int LDP = BM + 4;  // partial tile row: 8 q x 8 g on 32 banks
  constexpr int NA = MW == 1 ? 2 : 1;  // taps of A fragments in flight
  // aligned by pointer arithmetic on the shared array, not through an
  // integer, so the compiler keeps the address space: shared loads and
  // stores (LDS / STS), not generic ones
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sW = smem;
  uint8_t* qbands = sW + kStages * BN * 64;
  uint8_t* raws = qbands + 2 * s.q_bytes;
  int32_t* part = reinterpret_cast<int32_t*>(smem);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + s.pipe_bytes);
  uint64_t* w_empty = w_full + kStages;
  uint64_t* raw_full = w_empty + kStages;
  uint64_t* raw_empty = raw_full + kMaxRawStages;
  uint64_t* q_full = raw_empty + kMaxRawStages;
  uint64_t* q_empty = q_full + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const Tile k = decode_tile<Tin, BN>(s, blockIdx.x / s.splits);
  const int chunks = s.Cin / kChunk;
  const int c_lo = split * chunks / s.splits;
  const int c_hi = (split + 1) * chunks / s.splits;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < s.raw_stages; ++i) {
      mbar_init(&raw_full[i], 1);
      mbar_init(&raw_empty[i], kQuantThreads);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], kQuantThreads);
      mbar_init(&q_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A ring slot or band buffer is used for the u-th time with parity
  // (u / depth) & 1; a producer's first wait on "empty" passes at once.
  if (warp == kRawWarp) {
    if (lane == 0) {
      const uint32_t tx = (uint32_t)s.IMGS * s.BR * s.BWp * s.KS *
                          (uint32_t)sizeof(Tin);
      int use = 0;
      for (int c = c_lo; c < c_hi; ++c)
        for (int sub = 0; sub < kChunk / s.KS; ++sub, ++use) {
          const int rs = use % s.raw_stages;
          mbar_wait(&raw_empty[rs], ((use / s.raw_stages) & 1) ^ 1);
          mbar_expect(&raw_full[rs], tx);
          tma_load_4d(raws + rs * s.raw_bytes, &xmap, &raw_full[rs], k.wb,
                      k.h0 * s.stride - 1, c * kChunk + sub * s.KS, k.b0);
        }
    }
    __syncwarp();
    all_roles_done();
  } else if (warp == kWeightWarp) {
    if (lane == 0) {
      int use = 0;
      for (int c = c_lo; c < c_hi; ++c)
        for (int tap = 0; tap < 9; ++tap, ++use) {
          const int slot = use % kStages;
          mbar_wait(&w_empty[slot], ((use / kStages) & 1) ^ 1);
          mbar_expect(&w_full[slot], BN * 64);
          tma_load_2d(sW + slot * BN * 64, &wmap, &w_full[slot],
                      tap * s.Cin + c * kChunk, k.n0);
        }
    }
    __syncwarp();
    all_roles_done();
  } else if (warp < kRawWarp) {
    const float a = *a_scale_p, r = __frcp_rn(a);
    int raw_use = 0;
    for (int c = c_lo; c < c_hi; ++c) {
      const int qs = (c - c_lo) & 1, qu = (c - c_lo) >> 1;
      mbar_wait(&q_empty[qs], (qu & 1) ^ 1);
      quantize_chunk<Tin>(s, raws, raw_full, raw_empty,
                          qbands + qs * s.q_bytes, tid, kXformThreads, true,
                          raw_use, k.shift0, a, r);
      mbar_arrive(&q_full[qs]);
    }
    all_roles_done();
  } else {
    // Consumers.  This lane's A rows (ldmatrix.x4: lanes 0-7 / 8-15 / 16-23
    // / 24-31 give rows 0-7 / 8-15 / 0-7 / 8-15 of the warp's 16, bytes +0
    // / +0 / +16 / +16 of a k-step) and their band pixels at tap (0, 0).
    const int cw = warp - 8, wg = cw >> 2, khalf = lane >> 4;
    int centre[MW];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      const int p = wg * 64 * MW + mi * 64 + (cw & 3) * 16 + (lane & 7) +
                    ((lane >> 3) & 1) * 8;
      const int per = s.R * s.TW, i = p / per, rem = p - i * per;
      centre[mi] = i < s.IMGS
                       ? (i * s.BR + (rem / s.TW) * s.stride) * s.BWp +
                             (rem % s.TW) * s.stride + k.shift0
                       : 0;  // outside the tile: any band pixel
    }
    const float a = *a_scale_p, r = __frcp_rn(a);
    int acc[MW][BN / 2];  // the int32 sums
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0;
    int w_use = 0, raw_use = 0;
    for (int c = c_lo; c < c_hi; ++c) {
      const int qs = (c - c_lo) & 1, qu = (c - c_lo) >> 1;
      // the product warps' share of the chunk's quantize first: the band's
      // buffer is free, since every product warp arrived on the previous
      // chunk's q_full after its products of the chunk before
      quantize_chunk<Tin>(s, raws, raw_full, raw_empty,
                          qbands + qs * s.q_bytes, tid - kConsumerWarps * 32,
                          kConsumerWarps * 32, false, raw_use, k.shift0, a,
                          r);
      mbar_arrive(&q_full[qs]);
      mbar_wait(&q_full[qs], qu & 1);
      const uint32_t qb = smem_u32(qbands + qs * s.q_bytes);
      // With two fragment buffers, tap t's products run while tap t+1's
      // fragments load, and the stage of tap t-1 is released once its
      // group is done; with one (two m64 products, whose registers the
      // quantize needs), tap t is waited for first.
      uint32_t af[NA][MW][2][4];
      load_a<MW>(af[0], qb, centre, 0, khalf);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++w_use) {
        const int slot = w_use % kStages;
        mbar_wait(&w_full[slot], (w_use / kStages) & 1);
        const uint64_t desc = sw64_k_desc(sW + slot * BN * 64);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            // k-step ks starts 32 bytes further along the rows
            if constexpr (BN == 128)
              wgmma_s8_n128(acc[mi], af[tap % NA][mi][ks], desc + 2 * ks);
            else
              wgmma_s8_n64(acc[mi], af[tap % NA][mi][ks], desc + 2 * ks);
          }
        wgmma_commit();
        wgmma_wait<NA - 1>();
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) fence_acc(acc[mi]);
        if (tap + 1 >= NA && lane == 0)
          mbar_arrive(&w_empty[(w_use + 1 - NA) % kStages]);
        if (tap < 8)
          load_a<MW>(af[(tap + 1) % NA], qb, centre,
                     ((tap + 1) / 3) * s.BWp + (tap + 1) % 3, khalf);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) fence_acc(acc[mi]);
      if (lane == 0) {
        if (NA == 2) mbar_arrive(&w_empty[(w_use - 1) % kStages]);
        mbar_arrive(&q_empty[qs]);
      }
    }
    // every load has landed and been read: the pipeline's shared memory
    // now holds this split's int32 partial tile, [BN][LDP], pixels
    // contiguous
    all_roles_done();
    const int q = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pix = wg * 64 * MW + mi * 64 + (cw & 3) * 16 +
                        (lane >> 2) + 8 * half;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            part[(8 * j + 2 * q + e) * LDP + pix] =
                acc[mi][4 * j + 2 * half + e];
      }
  }
  cluster.sync();  // every split's partial tile is written

  // Rank `split` finishes its share of the tile's (channel, 8 pixels)
  // units: the splits' int32 partials summed (exact, in any order), one
  // dequant in JAX's order, 8 outputs along W a thread.
  const float a = *a_scale_p;
  const int G = BM / 8, units = BN * G;
  const int lo = split * units / s.splits, hi = (split + 1) * units / s.splits;
  const int64_t oplane = (int64_t)s.Ho * s.Wo;
  for (int u = lo + tid; u < hi; u += kTcThreads) {
    const int n = u / G, g = u - n * G;
    int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int rk = 0; rk < s.splits; ++rk) {
      const int4* src = reinterpret_cast<const int4*>(
          (s.splits == 1 ? part : cluster.map_shared_rank(part, rk)) +
          n * LDP + 8 * g);
      const int4 v0 = src[0], v1 = src[1];
      sum[0] += v0.x;
      sum[1] += v0.y;
      sum[2] += v0.z;
      sum[3] += v0.w;
      sum[4] += v1.x;
      sum[5] += v1.y;
      sum[6] += v1.z;
      sum[7] += v1.w;
    }
    const int nn = k.n0 + n;
    const float sc = __fmul_rn(a, w_scale[nn]);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = __fmul_rn(__int2float_rn(sum[e]), sc);
      if (bias != nullptr) v[e] = __fadd_rn(v[e], bias[nn]);
    }
    int b, ho, wo;
    Tout* plane_n = out + (int64_t)nn * oplane;
    if (s.TW % 8 == 0 && s.Wo % 8 == 0 &&
        out_pixel(s, 8 * g, k.b0, k.h0, k.w0, b, ho, wo) && wo + 7 < s.Wo) {
      store8<Tout>(plane_n + (int64_t)b * s.O * oplane + (int64_t)ho * s.Wo +
                       wo,
                   v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (out_pixel(s, 8 * g + e, k.b0, k.h0, k.w0, b, ho, wo))
          plane_n[(int64_t)b * s.O * oplane + (int64_t)ho * s.Wo + wo] =
              from_f<Tout>(v[e]);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partials
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

// Tensor map of a tensor of `rank` dims (innermost first) with `el`-byte
// elements, packed, read in boxes `box`.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int el,
                const void* base, int rank, const cuuint64_t* dims,
                const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  cuuint64_t strides[3];
  cuuint64_t st = el;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = st *= dims[i];
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int tc_smem(int BN, int MW, int npix, int KS, int RS, int el, int* q_bytes,
            int* raw_bytes, int* pipe_bytes) {
  *q_bytes = align_up(npix * kPix, 1024);
  *raw_bytes = align_up(npix * KS * el, 1024);
  const int pipe = kStages * BN * 64 + 2 * *q_bytes + RS * *raw_bytes;
  const int part = BN * (128 * MW + 4) * 4;  // after the main loop
  *pipe_bytes = align_up(pipe > part ? pipe : part, 8);
  return 1024 + *pipe_bytes + (2 * kStages + 2 * kMaxRawStages + 4) * 8;
}

template <typename Tin, typename Tout, int BN, int MW>
int launch_tc(const void* x, const void* wq, const void* a_scale,
              const void* w_scale, const void* bias, void* out, TcShape s,
              int blocks, cudaStream_t stream) {
  auto kernel = int8_conv3x3_wgmma_kernel<Tin, Tout, BN, MW>;
  constexpr int el = sizeof(Tin);
  const int npix = s.IMGS * s.BR * s.BWp;
  const int smem =
      tc_smem(BN, MW, npix, s.KS, s.raw_stages, el, &s.q_bytes, &s.raw_bytes,
              &s.pipe_bytes);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)s.W, (cuuint64_t)s.H,
                               (cuuint64_t)s.Cin, (cuuint64_t)s.B};
  const cuuint32_t xbox[4] = {(cuuint32_t)s.BWp, (cuuint32_t)s.BR,
                              (cuuint32_t)s.KS, (cuuint32_t)s.IMGS};
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * s.Cin, (cuuint64_t)s.O};
  const cuuint32_t wbox[2] = {64, BN};
  if (!encode_map(&xmap,
                  el == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  el, x, 4, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, 2, wdims, wbox,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorNotSupported;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)s.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, xmap, wmap, static_cast<const float*>(a_scale),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<Tout*>(out), s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_tc_tile(const void* x, const void* wq, const void* a_scale,
                   const void* w_scale, const void* bias, void* out,
                   const TcShape& s, int BN, int MW, int blocks,
                   cudaStream_t stream) {
  if (BN == 128)
    return launch_tc<Tin, Tout, 128, 1>(x, wq, a_scale, w_scale, bias, out, s,
                                        blocks, stream);
  if (MW == 2)
    return launch_tc<Tin, Tout, 64, 2>(x, wq, a_scale, w_scale, bias, out, s,
                                       blocks, stream);
  return launch_tc<Tin, Tout, 64, 1>(x, wq, a_scale, w_scale, bias, out, s,
                                     blocks, stream);
}

// ---------------------------------------------------------------------------
// Short-row path: weight-streaming s8 wgmma over whole images, K split
// ---------------------------------------------------------------------------

// Roles by warp: 0-7 (two warpgroups) load and quantize x into the band and
// run the products, 8 streams the weight tiles (one lane).
constexpr int kDeepThreads = 288;
constexpr int kDeepProductThreads = 256;
constexpr int kDeepBN = 64;       // output channels a CTA
constexpr int kDeepStages = 16;   // its ring of weight tiles: at the deep
// levels all of a split's tiles in flight (9 a CTA; 18 at Cin 1024)
// Each split's int32 partials land in the shared memory of the rank that
// finishes their channels: [splits][128 pixels][the rank's channels], for
// any splits <= 8 (the most at 6: 6 x 128 x 12 x 4 bytes)
constexpr int kDeepRecv = 36864;

// The geometry of one launch (int8_plan's "deep" plan in int8_conv.py):
// IMGS whole images a tile, their padded bands BH x BW pixels each.
struct DeepShape {
  int B, Cin, H, W, O, Ho, Wo, stride;
  int IMGS, BH, BW, splits, n_tiles, units, q_bytes, raw_bytes;
};

// The product warps (warps 0-7) alone.
__device__ __forceinline__ void product_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDeepProductThreads) : "memory");
}

// The cluster barrier in two halves: this thread has arrived (no ordering),
// and every thread of the cluster had arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Channels [c0, c0 + 64) of the tile's `imgs` images, one contiguous run an
// image in NCHW, into `raw` as they lie: 16-byte cp.async copies, all in
// flight at once, one commit group.
template <typename Tin>
__device__ __forceinline__ void load_raw(const Tin* __restrict__ x,
                                         uint8_t* raw, const DeepShape& s,
                                         int b0, int imgs, int c0, int tid) {
  const int hw = s.H * s.W;
  const int per = kChunk * hw * (int)sizeof(Tin) / 16;  // copies an image
  for (int v = tid; v < imgs * per; v += kDeepProductThreads) {
    const int i = v / per;
    const uint8_t* src =
        reinterpret_cast<const uint8_t*>(
            x + ((int64_t)(b0 + i) * s.Cin + c0) * hw) +
        16 * (v - i * per);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(raw + 16 * v)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The raw chunk (channel-major, as load_raw left it) into the pixel-major
// int8 band: a unit is one pixel by 8 channels, quantized without a branch
// (quantize_fast), the ties fixed by the true division, 8 bytes written at
// the pixel's place inside its image's halo, which stays zero.  A tie is
// ~1 element in 2000 at a served model's steps, so its loop is not
// unrolled (one division's code); a round step on bf16 inputs, such as
// 0.05, ties ~4% of elements and triples the quantize's time.
template <typename Tin>
__device__ __forceinline__ void quantize_band(const Tin* raw, uint8_t* band,
                                              const DeepShape& s, int imgs,
                                              float r, float a, int tid) {
  const int hw = s.H * s.W, pixels = imgs * hw;
  for (int u = tid; u < pixels * 8; u += kDeepProductThreads) {
    const int g = u / pixels, p = u - g * pixels;
    const int i = p / hw, rem = p - i * hw;
    const int h = rem / s.W, w = rem - h * s.W;
    const Tin* src = raw + (i * kChunk + 8 * g) * hw + rem;
    uint32_t q[2] = {0u, 0u}, tie = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[e >> 2] |= quantize_fast(to_f<Tin>(src[e * hw]), r, tie, e)
                   << (8 * (e & 3));
    uint64_t qq = ((uint64_t)q[1] << 32) | q[0];
#pragma unroll 1
    for (int e = 0; tie >> e; ++e)
      if (tie & (1u << e))
        qq = (qq & ~(0xffull << (8 * e))) |
             ((uint64_t)quantize_exact(to_f<Tin>(src[e * hw]), a) << (8 * e));
    const int bp = (i * s.BH + h + 1) * s.BW + w + 1;
    *reinterpret_cast<uint64_t*>(band + bp * kPix + 8 * g) = qq;
  }
}

// One tap's products: its weight tile waited for, the two k-steps (32
// channels each) issued and committed; then, once the group before has
// finished, that tap's ring slot released and the next tap's A fragments
// loaded into the registers it used.
__device__ __forceinline__ void deep_tap(int (&acc)[kDeepBN / 2],
                                         const uint32_t (&af)[1][2][4],
                                         uint32_t (&af_next)[1][2][4],
                                         uint8_t* sW, uint64_t* w_full,
                                         uint64_t* w_empty, int w_use,
                                         bool release, int next_tap,
                                         uint32_t qb, const int (&centre)[1],
                                         int BW, int khalf, int lane) {
  const int slot = w_use % kDeepStages;
  mbar_wait(&w_full[slot], (w_use / kDeepStages) & 1);
  const uint64_t desc = sw64_k_desc(sW + slot * kDeepBN * 64);
  wgmma_fence();
  // k-step ks starts 32 bytes further along the rows
  wgmma_s8_n64(acc, af[0][0], desc);
  wgmma_s8_n64(acc, af[0][1], desc + 2);
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
  if (release && lane == 0)
    mbar_arrive(&w_empty[(w_use - 1) % kDeepStages]);
  if (next_tap >= 0)
    load_a<1>(af_next, qb, centre, (next_tap / 3) * BW + next_tap % 3, khalf);
}

// One CTA per (tile, K split); the splits of a tile form one cluster.  A
// tile is IMGS whole images (at most 128 output pixels, one or two m64
// products) by kDeepBN output channels.  A split takes the (chunk, tap)
// units [u_lo, u_hi) of K, chunk-major, and streams one [64 x 64] weight
// tile a unit through a ring that holds them all at the deep levels.  Each
// chunk its units touch is loaded (the next one while the products of this
// one run), quantized once into the band, then multiplied tap by tap.
// The splits' int32 partials go straight into the shared memory of the
// rank that finishes their channels, which sums them there.  Shared
// memory: the weight ring, the band, the raw chunk, the received
// partials, then the barriers.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kDeepThreads, 1)
    int8_conv3x3_deep_kernel(const Tin* __restrict__ x,
                             const __grid_constant__ CUtensorMap wmap,
                             const float* __restrict__ a_scale_p,
                             const float* __restrict__ w_scale,
                             const float* __restrict__ bias,
                             Tout* __restrict__ out, const DeepShape s) {
  constexpr int BN = kDeepBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sW = smem;
  uint8_t* band = sW + kDeepStages * BN * 64;
  uint8_t* raw = band + s.q_bytes;
  int32_t* recv = reinterpret_cast<int32_t*>(raw + s.raw_bytes);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(recv + kDeepRecv / 4);
  uint64_t* w_empty = w_full + kDeepStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tile = blockIdx.x / s.splits;
  const int n0 = (tile % s.n_tiles) * BN;
  const int b0 = (tile / s.n_tiles) * s.IMGS;
  const int imgs = min(s.IMGS, s.B - b0);
  const int hwo = s.Ho * s.Wo, M = imgs * hwo;  // the tile's output pixels
  const int pwarps = M > 64 ? 8 : 4;  // warps with rows to multiply
  const int u_lo = split * s.units / s.splits;
  const int u_hi = (split + 1) * s.units / s.splits;
  const int c_lo = u_lo / 9, c_hi = (u_hi - 1) / 9 + 1;  // chunks touched
  // rank r finishes the channel pairs [r * 32 / splits, (r + 1) * 32 /
  // splits): at most cmax channels
  const int cmax = 2 * ((BN / 2 + s.splits - 1) / s.splits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the first chunk of x on its way while the barriers and the band are set
  if (warp < 8) load_raw<Tin>(x, raw, s, b0, imgs, c_lo * kChunk, tid);
  if (tid == 0) {
    for (int i = 0; i < kDeepStages; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], pwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the band's halo (and any image past the batch) stays zero: the padding
  for (int i = tid; i < s.q_bytes / 16; i += kDeepThreads)
    reinterpret_cast<uint4*>(band)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // no CTA writes into another's shared memory before all have started
  cluster_arrive_relaxed();

  if (warp == 8) {
    if (lane == 0) {
      // unit u is tap u % 9 of chunk u / 9: column tap * Cin + 64 chunk
      for (int u = u_lo, use = 0; u < u_hi; ++u, ++use) {
        const int slot = use % kDeepStages;
        mbar_wait(&w_empty[slot], ((use / kDeepStages) & 1) ^ 1);
        mbar_expect(&w_full[slot], BN * 64);
        tma_load_2d(sW + slot * BN * 64, &wmap, &w_full[slot],
                    (u % 9) * s.Cin + (u / 9) * kChunk, n0);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    // This lane's A rows (as in the tensor-core kernel: ldmatrix.x4 lanes
    // 0-7 / 8-15 / 16-23 / 24-31 give rows 0-7 / 8-15 / 0-7 / 8-15 of the
    // warp's 16, bytes +0 / +0 / +16 / +16 of a k-step) and their band
    // pixels at tap (0, 0).
    const int wg = warp >> 2, khalf = lane >> 4;
    const bool active = warp < pwarps;
    int centre[1];
    {
      const int p = wg * 64 + (warp & 3) * 16 + (lane & 7) +
                    ((lane >> 3) & 1) * 8;
      const int i = p / hwo, rem = p - i * hwo, ho = rem / s.Wo;
      centre[0] = p < M ? (i * s.BH + ho * s.stride) * s.BW +
                              (rem - ho * s.Wo) * s.stride
                        : 0;  // outside the tile: any band pixel
    }
    const float a = *a_scale_p, r = __frcp_rn(a);
    // two sums, taps alternating; added (exactly) at the end
    int acc[2][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[0][i] = acc[1][i] = 0;
    int w_use = 0;
    for (int c = c_lo; c < c_hi; ++c) {
      // chunk c has landed (this thread's copies, then everyone's), and
      // every product warp is done with the band's previous chunk
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      product_warps_sync();
      quantize_band<Tin>(reinterpret_cast<const Tin*>(raw), band, s, imgs, r,
                         a, tid);
      product_warps_sync();  // the band is whole, the raw chunk free
      if (c + 1 < c_hi)
        load_raw<Tin>(x, raw, s, b0, imgs, (c + 1) * kChunk, tid);
      if (!active) continue;
      const int t_lo = max(u_lo - 9 * c, 0), t_hi = min(u_hi - 9 * c, 9);
      const uint32_t qb = smem_u32(band);
      // tap t's products run while tap t - 1's finish and tap t + 1's
      // fragments load; a loop of two taps (unrolled over nine, or with
      // every tap in flight and one wait, it measured no faster)
      uint32_t af[2][1][2][4];
      load_a<1>(af[0], qb, centre, (t_lo / 3) * s.BW + t_lo % 3, khalf);
#pragma unroll 1
      for (int t = t_lo; t < t_hi; t += 2) {
        deep_tap(acc[0], af[0], af[1], sW, w_full, w_empty, w_use++,
                 t > t_lo, t + 1 < t_hi ? t + 1 : -1, qb, centre, s.BW,
                 khalf, lane);
        if (t + 1 < t_hi)
          deep_tap(acc[1], af[1], af[0], sW, w_full, w_empty, w_use++, true,
                   t + 2 < t_hi ? t + 2 : -1, qb, centre, s.BW, khalf, lane);
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(&w_empty[(w_use - 1) % kDeepStages]);
    }
    // this split's partials, channel pair by channel pair, into the rank
    // that finishes them: [split][pixel][its channels]
    cluster_wait();
    if (active) {
      const int q = lane & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int pr = 4 * j + q;  // channels 2 pr, 2 pr + 1
        const int r = ((pr + 1) * s.splits + BN / 2 - 1) / (BN / 2) - 1;
        int32_t* dst = cluster.map_shared_rank(recv, r) +
                       2 * (pr - r * (BN / 2) / s.splits);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pix = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * half;
          const int i = 4 * j + 2 * half;
          *reinterpret_cast<int2*>(dst + (split * 128 + pix) * cmax) =
              make_int2(acc[0][i] + acc[1][i], acc[0][i + 1] + acc[1][i + 1]);
        }
      }
    }
  }
  // This rank's channels: the splits' int32 partials summed (exact, in
  // any order) from its own shared memory, one dequant in JAX's order.
  // No CTA reads another's shared memory after the barrier: none waits to
  // leave.  A thread's first channel step and bias are loaded before it.
  const int ch0 = 2 * (split * (BN / 2) / s.splits);
  const int cw = 2 * ((split + 1) * (BN / 2) / s.splits) - ch0;
  const int units = cw * ((M + 3) / 4);
  const float a = *a_scale_p;
  float sc = 0.f, bi = 0.f;
  if (tid < units) {
    sc = __fmul_rn(a, w_scale[n0 + ch0 + tid % cw]);
    if (bias != nullptr) bi = bias[n0 + ch0 + tid % cw];
  }
  cluster.sync();  // every split's partials have landed
  for (int u = tid; u < units; u += kDeepThreads) {
    const int g = u / cw, c = u - g * cw;  // 4 pixels of channel ch0 + c
    int sum[4] = {0, 0, 0, 0};
    for (int sp = 0; sp < s.splits; ++sp) {
      const int32_t* src = recv + (sp * 128 + 4 * g) * cmax + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] += src[e * cmax];
    }
    const int nn = n0 + ch0 + c;
    if (u != tid) {
      sc = __fmul_rn(a, w_scale[nn]);
      if (bias != nullptr) bi = bias[nn];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * g + e;
      if (p >= M) break;
      float o = __fmul_rn(__int2float_rn(sum[e]), sc);
      if (bias != nullptr) o = __fadd_rn(o, bi);
      const int i = p / hwo;
      out[((int64_t)(b0 + i) * s.O + nn) * hwo + (p - i * hwo)] =
          from_f<Tout>(o);
    }
  }
}

int deep_smem(int npix, int raw_bytes, int* q_bytes) {
  *q_bytes = align_up(npix * kPix, 1024);
  return 1024 + kDeepStages * kDeepBN * 64 + *q_bytes + raw_bytes +
         kDeepRecv + 2 * kDeepStages * 8;
}

template <typename Tin, typename Tout>
int launch_deep(const void* x, const void* wq, const void* a_scale,
                const void* w_scale, const void* bias, void* out, DeepShape s,
                int blocks, cudaStream_t stream) {
  auto kernel = int8_conv3x3_deep_kernel<Tin, Tout>;
  s.raw_bytes = s.IMGS * kChunk * s.H * s.W * (int)sizeof(Tin);
  const int smem = deep_smem(s.IMGS * s.BH * s.BW, s.raw_bytes, &s.q_bytes);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap wmap;
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * s.Cin, (cuuint64_t)s.O};
  const cuuint32_t wbox[2] = {64, kDeepBN};
  if (!encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, 2, wdims, wbox,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorNotSupported;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kDeepThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)s.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Tin*>(x), wmap,
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<Tout*>(out), s);
  if (e != cudaSuccess) return (int)e;
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


// The tensor-core kernel: x [batch, Cin, H, W] contiguous, 16-byte aligned,
// bf16 (in_bf16 = 1) or fp32, a row W * elem a multiple of 16 bytes; wq:
// int8 [Cout][3][3][Cin], 16-byte aligned; a_scale, w_scale, bias, out as
// for sr3d_int8_conv3x3, out 16-byte aligned.  Cin and Cout multiples of
// 64; tile (int8_plan): BN 128 with MW 1, or BN 64 with MW 1 or 2; TW x R
// x IMGS <= 128 MW output pixels; BWp the band's padded width (a multiple
// of 16 bytes, >= (TW - 1) stride + 3 + 16 / elem - 1: the box starts on a
// 16-byte boundary at or left of the tile's halo); KS 16, 32 or 64
// channels a TMA box, RS of them in flight (2 to 8); splits <= min(8,
// Cin / 64) CTAs a cluster, one cluster a tile.  Returns a cudaError_t.
int sr3d_int8_conv3x3_wgmma(const void* x, const void* wq, const void* a_scale,
                            const void* w_scale, const void* bias, void* out,
                            int batch, int Cin, int H, int W, int Cout,
                            int stride, int in_bf16, int out_bf16, int BN,
                            int MW, int TW, int R, int IMGS, int BWp, int KS,
                            int RS, int splits, void* stream) {
  const int el = in_bf16 ? 2 : 4;
  TcShape s = {};
  s.B = batch;
  s.Cin = Cin;
  s.H = H;
  s.W = W;
  s.O = Cout;
  s.stride = stride;
  s.Ho = (H - 1) / stride + 1;
  s.Wo = (W - 1) / stride + 1;
  s.TW = TW;
  s.R = R;
  s.IMGS = IMGS;
  s.BR = (R - 1) * stride + 3;
  s.BWp = BWp;
  s.KS = KS;
  s.raw_stages = RS;
  s.splits = splits;
  if (batch < 1 || H < 1 || W < 1 || Cin < kChunk || Cin % kChunk ||
      Cout < BN || (stride != 1 && stride != 2) ||
      !((BN == 128 && MW == 1) || (BN == 64 && (MW == 1 || MW == 2))) ||
      Cout % BN || TW < 1 || R < 1 || IMGS < 1 ||
      (int64_t)TW * R * IMGS > 128 * MW || (W * el) % 16 ||
      (KS != 16 && KS != 32 && KS != 64) || RS < 2 || RS > kMaxRawStages ||
      splits < 1 || splits > 8 ||
      splits > Cin / kChunk || (BWp * el) % 16 ||
      BWp < (TW - 1) * stride + 3 + 16 / el - 1 || BWp > 256 || s.BR > 256 ||
      IMGS > 256 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
        reinterpret_cast<uintptr_t>(out)) &
       15))
    return (int)cudaErrorInvalidValue;
  s.n_tiles = Cout / BN;
  s.tiles_w = (s.Wo + TW - 1) / TW;
  s.tiles_h = (s.Ho + R - 1) / R;
  const int64_t tiles = (int64_t)((batch + IMGS - 1) / IMGS) * s.tiles_h *
                        s.tiles_w * s.n_tiles;
  if (tiles * splits > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles * splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return launch_tc_tile<__nv_bfloat16, __nv_bfloat16>(
        x, wq, a_scale, w_scale, bias, out, s, BN, MW, blocks, st);
  if (in_bf16)
    return launch_tc_tile<__nv_bfloat16, float>(
        x, wq, a_scale, w_scale, bias, out, s, BN, MW, blocks, st);
  if (out_bf16)
    return launch_tc_tile<float, __nv_bfloat16>(
        x, wq, a_scale, w_scale, bias, out, s, BN, MW, blocks, st);
  return launch_tc_tile<float, float>(x, wq, a_scale, w_scale, bias, out, s,
                                      BN, MW, blocks, st);
}

// The short-row kernel: x [batch, Cin, H, W] contiguous, 16-byte aligned,
// bf16 (in_bf16 = 1) or fp32, any W; wq: int8 [Cout][3][3][Cin], 16-byte
// aligned; a_scale, w_scale, bias, out as for sr3d_int8_conv3x3.  Cin and
// Cout multiples of 64; IMGS whole images a tile, IMGS * Ho * Wo <= 128
// (int8_plan); splits <= min(8, 9 Cin / 64) CTAs a cluster, one cluster a
// tile.  Returns a cudaError_t.
int sr3d_int8_conv3x3_deep(const void* x, const void* wq, const void* a_scale,
                           const void* w_scale, const void* bias, void* out,
                           int batch, int Cin, int H, int W, int Cout,
                           int stride, int in_bf16, int out_bf16, int IMGS,
                           int splits, void* stream) {
  DeepShape s = {};
  s.B = batch;
  s.Cin = Cin;
  s.H = H;
  s.W = W;
  s.O = Cout;
  s.stride = stride;
  s.Ho = (H - 1) / stride + 1;
  s.Wo = (W - 1) / stride + 1;
  s.IMGS = IMGS;
  s.BH = (s.Ho - 1) * stride + 3;
  s.BW = (s.Wo - 1) * stride + 3;
  s.splits = splits;
  s.units = 9 * (Cin / kChunk);
  if (batch < 1 || H < 1 || W < 1 || Cin < kChunk || Cin % kChunk ||
      Cout < kDeepBN || Cout % kDeepBN || (stride != 1 && stride != 2) ||
      IMGS < 1 || (int64_t)IMGS * s.Ho * s.Wo > 128 || splits < 1 ||
      splits > 8 || splits > s.units ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq)) &
       15))
    return (int)cudaErrorInvalidValue;
  s.n_tiles = Cout / kDeepBN;
  const int64_t tiles = (int64_t)((batch + IMGS - 1) / IMGS) * s.n_tiles;
  if (tiles * splits > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles * splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return launch_deep<__nv_bfloat16, __nv_bfloat16>(
        x, wq, a_scale, w_scale, bias, out, s, blocks, st);
  if (in_bf16)
    return launch_deep<__nv_bfloat16, float>(x, wq, a_scale, w_scale, bias,
                                             out, s, blocks, st);
  if (out_bf16)
    return launch_deep<float, __nv_bfloat16>(x, wq, a_scale, w_scale, bias,
                                             out, s, blocks, st);
  return launch_deep<float, float>(x, wq, a_scale, w_scale, bias, out, s,
                                   blocks, st);
}

}  // extern "C"
