// Single-head spatial self-attention forward for Hopper (sm_90a).
//
// Replaces _attn_pallas (_attn_kernel) of sr3d_tpu/kernels/attention.py:
// out = softmax(Q K^T * scale) V over all HW tokens, q, k, v, out [B, HW, C],
// fp32 scores, max-subtracted softmax, the probabilities rounded to v's type
// before P V (as _attn_kernel does), fp32 accumulation, out in q's type.
// The scale is 1/sqrt(C) over the full channel count; the caller passes it.
// P is rounded only once normalised by its row's full sum (the score rows
// stay on chip, or a first pass finds each row's max and sum), never as an
// unnormalised online-softmax P: exactly where the reference rounds it.
//
// What bounds it on an H100: at the 16->128 mid block, [8, 64, 512] bf16,
// it moves 2 MB (three reads and one write, ~0.6 us at 3.35 TB/s) and does
// 67 MFLOP (~0.07 us at the bf16 tensor-core peak).  Both are tiny: what
// sets the time is latency and how many SMs take part.  At 1024 tokens
// ([8, 1024, 512], the default attn_res over 256^2 data) it does 17.2 GFLOP
// (0.017 ms at the peak) on 33.5 MB (0.010 ms): the products bound it.  The
// head dim 512 is above PyTorch's flash-attention cap, which is why the
// port writes its own.
//
// Two kernels; the wrapper's plan (attn_plan in attention.py) picks one by
// dtype and shape, never by failure:
//
// attn_mma_kernel (plan path mma): bf16, C a multiple of 8, HW <= 256.  All
// the score rows of a 64-query tile on chip, tensor cores over a cluster.
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
// attn_tiled_kernel<T> (plan paths long and simt): any HW, any C; bf16 on
// the tensor cores (mma.sync m16n8k16), fp32 in 3xTF32 (each operand split
// into a TF32 hi and lo, a_lo b_hi + a_hi b_lo + a_hi b_hi by mma.sync
// m16n8k8: about fp32's accuracy, where TF32 alone keeps ~3 digits).  The
// score rows no longer fit, so it makes two passes over 64-key tiles, with
// attn_mma_kernel's split of the channels:
//   * Grid: one CTA per (cluster rank, 64-query tile, image), clusters of
//     S = min(8, ceil(C/64)); rank r owns 64-channel slices r, r + S, ...
//     and the tile's rows [ceil(64 r / S), ceil(64 (r + 1) / S)).  Every
//     CTA reads its slice of each K and V tile once a pass, so a cluster
//     reads a tile once, and L2 serves K twice and V once per query tile.
//   * One stream of key tiles: T of pass 1, then T per output round (one
//     round unless C > 512: then rank r's slices r, r + S, ... are rounds,
//     and pass 2 recomputes the scores for each).  Iteration u: (a) the
//     partial scores of tile u over the rank's slices (computed in
//     iteration u - 1) go to the ranks owning their rows; (b) each rank
//     adds the S partials of tile u - 1 for its rows in rank order (no
//     atomics: repeats are bit-equal), scales, and in pass 1 updates the
//     running max m and sum l = sum exp(s - m) (rescaled when m grows), in
//     pass 2 forms P = exp(s - m) / l, rounds it to T (after the division,
//     where the reference rounds it) and sends it to every rank; (c) each
//     rank adds P V_s of tile u - 2 for its slice (a warp: 16 rows x 32
//     channels).  Then it computes tile u + 1's partial scores.
//   * Exchange: the partials and P travel by st.async into the receiver's
//     shared memory, each store completing its bytes on the receiver's
//     mbarrier, which the receiver waits on; one relaxed cluster barrier an
//     iteration keeps a sender from overwriting a buffer still being read
//     (two buffers of partials and of P; K and V in rings of three tiles,
//     cp.async issued two iterations ahead).
//   * What bounds it: the exchange, not the products.  Each CTA sends its
//     64 x 64 fp32 partials (16 KB) and its rows of P every tile through
//     the cluster network, which moves about 16 bytes a cycle an SM; in
//     bf16 the softmax step (its wait for the partials, its P sends) and
//     the cluster barrier's wait take ~60% of an iteration, the products
//     ~25% (python -m sr3d_torch.profile_attention --phases).  64 x 64
//     tiles were the fastest measured (--tiles) and send P 4 or 8 bytes a
//     store.
//   * Loads: 16 bytes a thread with cp.async where rows are multiples of
//     16 bytes; otherwise (C % 8 != 0 in bf16) one element a thread.
//   * Ragged tiles as in attn_mma_kernel; keys past HW get s = -inf.
//   * ~118 KB (bf16) or ~195 KB (fp32) of shared memory: one CTA an SM.

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

// ---- the tiled cluster kernel (plan paths long and simt) ------------------
constexpr int kTiledThreads = 256;  // 8 warps
constexpr int kRing = 3;            // K and V tiles in flight

template <typename T>
struct Tiled;
template <>
struct Tiled<__nv_bfloat16> {   // mma.sync m16n8k16 on bf16
  static constexpr int QT = 64;   // query rows: 4 warps x 16, x 2 halves
  static constexpr int KT = 64;   // keys a tile
  static constexpr int LDQ = 72, LDK = 72, LDV = 72;  // 144-byte rows (ldmatrix)
  static constexpr int LDP = KT + 8;  // rows of 16 bytes x an odd number
  static constexpr int KTR = KT + 8;  // fp32 row stride of received partials
  static constexpr int kMinBlocks = 1;  // ~118 KB of shared memory
};
template <>
struct Tiled<float> {           // 3xTF32: mma.sync m16n8k8 on hi/lo halves
  static constexpr int QT = 64;   // 4 warps x 16 rows, x 2 halves
  static constexpr int KT = 64;
  static constexpr int LDQ = 68, LDK = 68;  // (row g, col t4) loads: banks 4g + t4
  static constexpr int LDV = 72;            // (row t4, col g) loads: banks 8t4 + g
  static constexpr int LDP = KT + 4;
  static constexpr int KTR = KT + 8;
  static constexpr int kMinBlocks = 1;  // ~195 KB of shared memory
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct TiledLayout {
  int q, k, v, p, r, m, l, bytes;  // byte offsets of the regions, total
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// shared memory of one CTA in a cluster of S: its Q slice, the K and V
// rings, P for two tiles, the partial scores its rows receive for two tiles
// (S sources x ceil(QT / S) rows), its rows' running max m and sum l
template <typename T>
__host__ __device__ TiledLayout tiled_layout(int S) {
  using P = Tiled<T>;
  const int rpr = (P::QT + S - 1) / S;
  TiledLayout L{};
  int o = 0;
  L.q = o, o += P::QT * P::LDQ * (int)sizeof(T);
  L.k = o, o += kRing * P::KT * P::LDK * (int)sizeof(T);
  L.v = o, o += kRing * P::KT * P::LDV * (int)sizeof(T);
  L.p = o, o += 2 * P::QT * P::LDP * (int)sizeof(T);
  L.r = o, o += 2 * S * rpr * P::KTR * 4;
  L.m = o, o += align16(rpr * 4);
  L.l = o, o += align16(rpr * 4);
  L.bytes = o;
  return L;
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// A store into a cluster peer's shared memory (addr) that completes its
// bytes of the transaction on the peer's mbarrier (mbar), both
// shared::cluster addresses: the sender neither fences nor waits.
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t mbar, float a,
                                         float b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint32_t mbar,
                                         uint32_t a) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(a), "r"(mbar)
      : "memory");
}

// a row's P for this lane's KPL keys, rounded to T, into a peer: 4 or 8
// bytes a store (bf16 with one key a lane: the even lane stores the pair)
__device__ __forceinline__ void push_p(uint32_t addr, uint32_t mbar,
                                       const float (&p)[1], int lane) {
  st_async(addr, mbar, __float_as_uint(p[0]));
}

__device__ __forceinline__ void push_p(uint32_t addr, uint32_t mbar,
                                       const float (&p)[2], int lane) {
  st_async(addr, mbar, p[0], p[1]);
}

__device__ __forceinline__ void push_p(uint32_t addr, uint32_t mbar,
                                       const __nv_bfloat16 (&p)[1], int lane) {
  const uint32_t mine = (uint32_t)__bfloat16_as_ushort(p[0]);
  const uint32_t next = __shfl_down_sync(0xffffffffu, mine, 1);
  if (!(lane & 1)) st_async(addr, mbar, mine | next << 16);
}

__device__ __forceinline__ void push_p(uint32_t addr, uint32_t mbar,
                                       const __nv_bfloat16 (&p)[2], int lane) {
  st_async(addr, mbar,
           (uint32_t)__bfloat16_as_ushort(p[0]) |
               (uint32_t)__bfloat16_as_ushort(p[1]) << 16);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// this phase's one arrival, and the bytes it waits for
__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed; a wait that
// never ends (a bug, not a slow store) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// an execution barrier of the cluster without release semantics (~0.1 us
// against ~0.5 us with them on an H100): the data itself travels by
// st.async and is awaited on mbarriers
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (round to nearest, ties away, as cvt.rna does)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  lo &= 0xffffe000u;
}

// d += a * b, m16n8k8, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, below
// fp32's rounding, is dropped), small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// rows [row0, row0 + rows) x channels [c0, c0 + 64) of an [hw, C] matrix
// into a [rows][ld] tile, zeros past hw and C: 16 bytes a thread by
// cp.async where rows are 16-byte multiples (vec), else one element at a
// time (C % 8 != 0 in bf16, C % 4 != 0 in fp32)
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int rows, int hw, int C,
                                          int c0, bool vec) {
  if (vec) {
    constexpr int EV = 16 / sizeof(T), NV = CS / EV;
    for (int i = threadIdx.x; i < rows * NV; i += kTiledThreads) {
      const int r = i / NV, c = (i % NV) * EV;
      const bool ok = row0 + r < hw && c0 + c < C;
      cp_async16(dst + r * ld + c,
                 ok ? src + (int64_t)(row0 + r) * C + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * CS; i += kTiledThreads) {
      const int r = i / CS, c = i % CS;
      dst[r * ld + c] = row0 + r < hw && c0 + c < C
                            ? src[(int64_t)(row0 + r) * C + c0 + c]
                            : from_f<T>(0.f);
    }
  }
}

// partial scores of the warp's 16 query rows x KW keys over one 64-channel
// slice: sQ [QT][LDQ], sK [KT][LDK]
template <int KW>
__device__ __forceinline__ void tile_scores(float (&acc)[KW / 8][4],
                                            const __nv_bfloat16* sQ,
                                            const __nv_bfloat16* sK, int wr,
                                            int kw0, int lane) {
  using P = Tiled<__nv_bfloat16>;
#pragma unroll
  for (int ks = 0; ks < CS / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, sQ + (wr + (lane & 15)) * P::LDQ + ks * 16 +
                       (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < KW / 16; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, sK + (kw0 + nb * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                              P::LDK +
                         ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], a, b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

template <int KW>
__device__ __forceinline__ void tile_scores(float (&acc)[KW / 8][4],
                                            const float* sQ, const float* sK,
                                            int wr, int kw0, int lane) {
  using P = Tiled<float>;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < CS / 8; ++ks) {
    const float* qa = sQ + (wr + g) * P::LDQ + ks * 8 + t4;
    const float a[4] = {qa[0], qa[8 * P::LDQ], qa[4], qa[8 * P::LDQ + 4]};
#pragma unroll
    for (int n = 0; n < KW / 8; ++n) {
      const float* kb = sK + (kw0 + n * 8 + g) * P::LDK + ks * 8 + t4;
      mma_3xtf32(acc[n], a, kb[0], kb[4]);
    }
  }
}

// out += P V for the warp's 16 rows x CW channels over one key tile:
// sP [QT][LDP], sV [KT][LDV]
template <int CW>
__device__ __forceinline__ void tile_pv(float (&acc)[CW / 8][4],
                                        const __nv_bfloat16* sP,
                                        const __nv_bfloat16* sV, int wr,
                                        int cw0, int lane) {
  using P = Tiled<__nv_bfloat16>;
#pragma unroll
  for (int k0 = 0; k0 < P::KT; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, sP + (wr + (lane & 15)) * P::LDP + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < CW / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sV + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    P::LDV +
                               cw0 + n * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * n], a, b[0], b[1]);
      mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
    }
  }
}

template <int CW>
__device__ __forceinline__ void tile_pv(float (&acc)[CW / 8][4],
                                        const float* sP, const float* sV,
                                        int wr, int cw0, int lane) {
  using P = Tiled<float>;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < P::KT / 8; ++ks) {
    const float* pa = sP + (wr + g) * P::LDP + ks * 8 + t4;
    const float a[4] = {pa[0], pa[8 * P::LDP], pa[4], pa[8 * P::LDP + 4]};
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      const float* vb = sV + (ks * 8 + t4) * P::LDV + cw0 + n * 8 + g;
      mma_3xtf32(acc[n], a, vb[0], vb[4 * P::LDV]);
    }
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b,
                                           bool both, bool vec) {
  if (vec && both) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (both) p[1] = __float2bfloat16(b);
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool both, bool vec) {
  if (vec && both) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}

// One CTA per (cluster rank, QT-query tile, image); see the header.  The
// work is one stream of key tiles, u < T of pass 1, then T per output
// round; iteration u sends tile u's partials, reduces tile u - 1 and adds
// P V of tile u - 2, and after a relaxed cluster barrier's arrive computes
// tile u + 1's partials before it waits.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads, Tiled<T>::kMinBlocks)
    attn_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int hw,
                      int C, float scale, int vec) {
  using P = Tiled<T>;
  constexpr int QT = P::QT, KT = P::KT, KTR = P::KTR, NRG = QT / 16;
  constexpr int NCP = 8 / NRG, KPL = KT / 32;  // column parts; keys a lane
  constexpr int KW = KT / NCP, CW = CS / NCP;  // a warp's keys and channels
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const TiledLayout L = tiled_layout<T>(S);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  const float* sR = reinterpret_cast<const float*>(smem + L.r);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  const uint32_t sR_u = smem_u32(smem + L.r), sP_u = smem_u32(sP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp % NRG) * 16, cp = warp / NRG;
  const int q0 = blockIdx.y * QT;
  const int64_t base = (int64_t)blockIdx.z * hw * C;
  const int nslices = (C + CS - 1) / CS, nsl = (nslices + S - 1) / S;
  const bool multi = nsl > 1;  // C > 512: slices loaded one at a time
  const int T_ = (hw + KT - 1) / KT, NU = T_ * (1 + nsl);
  const int rpr = (QT + S - 1) / S;
  // this rank's rows of the tile: [ceil(QT r / S), ceil(QT (r + 1) / S))
  const int r0 = (QT * rank + S - 1) / S;
  const int own = (QT * (rank + 1) + S - 1) / S - r0;
  const bool vc = vec != 0;

  // full_r[b], full_p[b]: the partials this rank's rows receive, and P,
  // for the tiles in buffer b; one arrival (the arming thread) and the
  // bytes of the peers' st.async stores complete a phase
  __shared__ __align__(8) uint64_t bars[4];
  const uint32_t full_r = smem_u32(&bars[0]), full_p = smem_u32(&bars[2]);
  uint32_t phase = 0;  // bit b: parity of full_r[b]; bit 2 + b: full_p[b]
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < rpr; i += kTiledThreads) sM[i] = -INFINITY, sL[i] = 0.f;
  cluster_arrive();  // every CTA runs, its mbarriers set, before any push

  float sacc[KW / 8][4];
  float oacc[CW / 8][4];
  if (!multi) load_tile(sQ, P::LDQ, q + base, q0, QT, hw, C, rank * CS, vc);
  if (!multi) load_tile(sK, P::LDK, k + base, 0, KT, hw, C, rank * CS, vc);
  cp_async_commit();

  // iteration -1 only loads and computes tile 0's partial scores
  for (int u = -1; u <= NU + 1; ++u) {
    cluster_wait();
    // issue V of pass-2 tile u (read at iteration u + 2) and K of tile
    // u + 2 (read at the end of iteration u + 1) into their ring slots
    if (u >= T_ && u < NU && rank + (u / T_ - 1) * S < nslices)
      load_tile(sV + (u % kRing) * KT * P::LDV, P::LDV, v + base,
                (u % T_) * KT, KT, hw, C, (rank + (u / T_ - 1) * S) * CS, vc);
    cp_async_commit();
    if (!multi && u + 2 < NU)
      load_tile(sK + ((u + 2) % kRing) * KT * P::LDK, P::LDK, k + base,
                ((u + 2) % T_) * KT, KT, hw, C, rank * CS, vc);
    cp_async_commit();
    if (tid == 0) {  // arm this iteration's receive buffers
      if (u >= 0 && u < NU)
        mbar_arm(full_r + 8 * (u & 1), (uint32_t)(S * own * KT * 4));
      if (u - 1 >= T_ && u - 1 < NU)
        mbar_arm(full_p + 8 * ((u - 1) & 1), (uint32_t)(QT * KT * sizeof(T)));
    }
    if (u >= 0 && u < NU) {  // (a) tile u's partials to their rows' owners
      const uint32_t buf = sR_u + (uint32_t)((u & 1) * S * rpr * KTR) * 4;
      const uint32_t bar = full_r + 8 * (u & 1);
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wr + g + 8 * h, owner = row * S / QT;
          const int lrow = row - (QT * owner + S - 1) / S;
          const uint32_t a =
              buf + (uint32_t)(((rank * rpr + lrow) * KTR + cp * KW + 8 * j +
                                2 * t4) *
                               4);
          st_async(mapa(a, owner), mapa(bar, owner), sacc[j][2 * h],
                   sacc[j][2 * h + 1]);
        }
    }
    if (u >= 1 && u <= NU) {  // (b) tile u - 1, this rank's rows
      const int w = u - 1, key = (w % T_) * KT + KPL * lane;
      const float* R = sR + (w & 1) * S * rpr * KTR + KPL * lane;
      mbar_wait(full_r + 8 * (w & 1), (phase >> (w & 1)) & 1);
      phase ^= 1u << (w & 1);
      for (int lrow = warp; lrow < own; lrow += kTiledThreads / 32) {
        float s[KPL];
#pragma unroll
        for (int i = 0; i < KPL; ++i) s[i] = R[lrow * KTR + i];
        for (int src = 1; src < S; ++src)
#pragma unroll
          for (int i = 0; i < KPL; ++i) s[i] += R[(src * rpr + lrow) * KTR + i];
        float mt = -INFINITY;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          s[i] = key + i < hw ? s[i] * scale : -INFINITY;
          mt = fmaxf(mt, s[i]);
        }
        if (w < T_) {  // pass 1
          const float m = sM[lrow], mn = fmaxf(m, warp_max(mt));
          float e = 0.f;
#pragma unroll
          for (int i = 0; i < KPL; ++i) e += expf(s[i] - mn);
          const float l = sL[lrow] * expf(m - mn) + warp_sum(e);
          if (lane == 0) sM[lrow] = mn, sL[lrow] = l;
        } else {  // pass 2: P rounded to T after the division, to every rank
          const float m = sM[lrow], l = sL[lrow];
          T p[KPL];
#pragma unroll
          for (int i = 0; i < KPL; ++i)
            p[i] = from_f<T>(key + i < hw ? expf(s[i] - m) / l : 0.f);
          const uint32_t a = sP_u + (uint32_t)((((w & 1) * QT + r0 + lrow) *
                                                    P::LDP +
                                                KPL * lane) *
                                               sizeof(T));
          for (int r = 0; r < S; ++r)
            push_p(mapa(a, r), mapa(full_p + 8 * (w & 1), r), p, lane);
        }
      }
    }
    if (u - 2 >= T_) {  // (c) P V of pass-2 tile u - 2
      const int w = u - 2, kt = w % T_, sl = rank + (w / T_ - 1) * S;
      mbar_wait(full_p + 8 * (w & 1), (phase >> (2 + (w & 1))) & 1);
      phase ^= 1u << (2 + (w & 1));
      if (sl < nslices) {
        if (kt == 0)
#pragma unroll
          for (int j = 0; j < CW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
        tile_pv<CW>(oacc, sP + (w & 1) * QT * P::LDP,
                    sV + (w % kRing) * KT * P::LDV, wr, cp * CW, lane);
        if (kt == T_ - 1) {
#pragma unroll
          for (int j = 0; j < CW / 8; ++j) {
            const int c = sl * CS + cp * CW + 8 * j + 2 * t4;
            if (c >= C) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = q0 + wr + g + 8 * h;
              if (row < hw)
                store_pair(out + base + (int64_t)row * C + c, oacc[j][2 * h],
                           oacc[j][2 * h + 1], c + 1 < C, vc);
            }
          }
        }
      }
    }
    cluster_arrive_relaxed();  // this iteration's reads are done
    // the next tile's partial scores while the other ranks catch up
    cp_async_wait<2>();  // K of tile u + 1, V of tile u - 1
    __syncthreads();
    if (u + 1 < NU) {
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      if (!multi) {
        tile_scores<KW>(sacc, sQ, sK + ((u + 1) % kRing) * KT * P::LDK, wr,
                        cp * KW, lane);
      } else {
        for (int sl = rank; sl < nslices; sl += S) {  // in slice order
          load_tile(sQ, P::LDQ, q + base, q0, QT, hw, C, sl * CS, vc);
          load_tile(sK, P::LDK, k + base, ((u + 1) % T_) * KT, KT, hw, C,
                    sl * CS, vc);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          tile_scores<KW>(sacc, sQ, sK, wr, cp * KW, lane);
          __syncthreads();  // sQ and sK are rewritten by the next slice
        }
      }
    }
  }
  cluster_wait();
}

}  // namespace

extern "C" {

// The tensor-core kernel: q, k, v, out [batch, hw, C] bf16, contiguous,
// 16-byte aligned, C % 8 == 0, hw <= 256; cluster = min(8, ceil(C / 64)).
// Returns the launch's cudaError_t.
int sr3d_attention_mma_fwd(const void* q, const void* k, const void* v,
                           void* out, int batch, int hw, int C, float scale,
                           int cluster, void* stream) {
  const int slices = (C + CS - 1) / CS;
  const int want = slices < kMaxCluster ? slices : kMaxCluster;
  if (hw > kMaxHW || hw < 1 || C < 1 || C % 8 || batch < 1 ||
      batch > 65535 || cluster != want ||
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
  cfg.stream = static_cast<cudaStream_t>(stream);
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
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      hw, C, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

template <typename T>
int launch_tiled(const void* q, const void* k, const void* v, void* out,
                 int batch, int hw, int C, float scale, int cluster, int vec,
                 cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    int most = 0;
    for (int c = 1; c <= kMaxCluster; ++c)
      most = tiled_layout<T>(c).bytes > most ? tiled_layout<T>(c).bytes : most;
    const cudaError_t e = cudaFuncSetAttribute(
        attn_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster,
                     (unsigned)((hw + Tiled<T>::QT - 1) / Tiled<T>::QT),
                     (unsigned)batch);
  cfg.blockDim = dim3(kTiledThreads);
  cfg.dynamicSmemBytes = (size_t)tiled_layout<T>(cluster).bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, attn_tiled_kernel<T>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      hw, C, scale, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiled cluster kernel, any hw, any C: q, k, v, out [batch, hw, C],
// contiguous, bf16 (is_bf16 = 1, tensor cores) or fp32 (3xTF32); cluster =
// min(8, ceil(C / 64)); vec = 1 loads 16 bytes a thread, which needs rows
// of a multiple of 16 bytes and 16-byte aligned pointers.  Returns the
// launch's cudaError_t.
int sr3d_attention_tiled_fwd(const void* q, const void* k, const void* v,
                             void* out, int batch, int hw, int C, float scale,
                             int is_bf16, int cluster, int vec, void* stream) {
  const int slices = (C + CS - 1) / CS;
  const int want = slices < kMaxCluster ? slices : kMaxCluster;
  const int el = is_bf16 ? 2 : 4;
  if (hw < 1 || C < 1 || batch < 1 || batch > 65535 || cluster != want ||
      (vec && ((C * el) % 16 ||
               ((reinterpret_cast<uintptr_t>(q) |
                 reinterpret_cast<uintptr_t>(k) |
                 reinterpret_cast<uintptr_t>(v) |
                 reinterpret_cast<uintptr_t>(out)) &
                15))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tiled<__nv_bfloat16>(q, k, v, out, batch, hw, C,
                                               scale, cluster, vec, s)
                 : launch_tiled<float>(q, k, v, out, batch, hw, C, scale,
                                       cluster, vec, s);
}

}  // extern "C"
