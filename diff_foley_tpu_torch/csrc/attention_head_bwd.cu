// Per-head softmax attention backward over (B, H, L, D) for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_bwd_kernel
// (launched by _pallas_backward, vjp _bwd of flash_attention). Given the
// saved q, k, v and the output gradient g:
//   P  = softmax(Q Kᵀ · scale)                       (recomputed, fp32)
//   dV = P̃ᵀ g            with P̃ = P cast to g's type
//   dS = P ∘ (g Vᵀ − Σ_j (g Vᵀ ∘ P))  cast to q's type
//   dQ = dS K · scale,   dK = dSᵀ Q · scale
// with fp32 accumulation; dQ, dK and dV are returned in the operand type.
// The path runs it in the VAE's single-head mid attention (B, 1, 1024, 512)
// of the first-stage train step, encoder and decoder; the tiny agreement
// VAE at D 32.
//
// The TPU kernel holds a query chunk's whole (Qc, Lk) score matrix in VMEM
// and runs the five products on the MXU. Here the card's 50 MB L2 plays
// that role: the scores of one call live in a scratch buffer the wrapper
// allocates (B·H·Lq·Lk fp32 for S and for g Vᵀ, the same count in the
// operand type for P̃ and dS; 64 MB at (4, 1, 1024, 512) in fp32). Three
// launches, five products, nothing recomputed:
//   1. head_bwd_scores_kernel: S = Q Kᵀ and dP = g Vᵀ, one 64×64 tile and
//      one of the two products per block, fp32 into the scratch.
//   2. head_bwd_rows_kernel, one warp per query row: m, l, P = e/l in fp32,
//      δ = Σ_j P·dP (as Σ_j e·dP / l); writes P̃ and dS rounded to the
//      operand type (the plain version's roundings).
//   3. head_bwd_products_kernel: dQ = dS·K·scale, dK = dSᵀ·Q·scale and
//      dV = P̃ᵀ·g, blockIdx.z choosing the product; each output tile is
//      written once in q's, k's or v's strides. No atomics.
//
// Every product is one tile GEMM (gemm_tile): 64×64 block tiles, 32-deep
// k-tiles copied global → shared by 16-byte cp.async, GEMM_STAGES of them
// in flight, four warps of 32×32 on mma.sync. An operand tile keeps the
// orientation it has in memory: "k-contiguous" ([r][k], e.g. row-major Q
// along D) or "r-contiguous" ([k][r], e.g. the VAE's NCHW token views,
// stride 1 along L, and dSᵀ); fragment loads read either, and the row
// padding (fp32: 36 or 72 floats, bf16: 40 or 72 elements) keeps them free
// of bank conflicts. bf16 operands go through ldmatrix (.trans where the
// tile's contiguous axis is not the fragment's pair axis) into m16n8k16
// products. fp32 operands use 3xTF32: each element is split into big +
// small TF32 parts and three m16n8k8 products (small·big, big·small,
// big·big) keep fp32 accuracy at up to a third of the TF32 rate. The
// tensor cores' fp32 sums lose accuracy along a chain of products, so the
// small terms get accumulators of their own and each k-tile's sums are
// added into separate fp32 registers: a chain spans 32 depths.
//
// Bound on this card: 10·B·H·Lq·Lk·D operations (five products) against
// (3·Lq + 4·Lk)·B·H·D operand elements: operation-bound at L 1024, D 512,
// at 989 TFLOP/s in bf16 and 495/3 = 165 TFLOP/s for fp32-accurate 3xTF32.
// The scratch traffic (S, dP written once and read by the row pass, P̃ and
// dS written once and read by the products) is ~100 MB at the train shape,
// mostly in L2. wgmma and TMA would reach more of the rate; later work.
#include "mma.cuh"

namespace dft {

struct Strides {
  long long b, h, l, d;
};

constexpr int GM = 64;    // block tile rows (M) and columns (N)
constexpr int GK = 32;    // k-tile depth
constexpr int GNT = 128;  // four warps, 2 × 2 warp tiles of 32 × 32
constexpr int GEMM_STAGES = 3;  // k-tiles in flight
constexpr int ROW_WARPS = 8;

template <typename T>
struct GemmTile {
  static constexpr int E = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int LDK = GK + E;         // [r][k] tile: 36 fp32, 40 bf16
  static constexpr int LDR = GM + 8;         // [k][r] tile: 72
  static constexpr int STAGE =
      GM * LDK > GK * LDR ? GM * LDK : GK * LDR;  // elements per operand
  static constexpr int SMEM = 2 * GEMM_STAGES * STAGE * sizeof(T);
};

// The thread's 16-byte copies of one operand's k-tiles into shared memory.
// Element (r, k) lies at src[r·sr + k] (KC, k-contiguous) or src[k·sk + r]
// (r-contiguous); rows r ≥ R and depths k ≥ K are zero-filled. A thread
// always copies the same chunk column of NJ tile rows JSTEP apart, so its
// addresses are set up once and each k-tile only adds an offset.
template <typename T, bool KC>
struct TileLoader {
  using G = GemmTile<T>;
  static constexpr int E = G::E;
  static constexpr int CPR = (KC ? GK : GM) / E;   // chunks per tile row
  static constexpr int NJ = (KC ? GM : GK) * CPR / GNT;
  static constexpr int JSTEP = GNT / CPR;          // tile rows apart
  static constexpr int LD = KC ? G::LDK : G::LDR;

  const T* base;     // a valid address for the empty copies
  const T* p;        // the thread's first chunk of k-tile 0
  long long jstep;   // elements between the thread's chunks
  long long kstep;   // elements between k-tiles
  int soff;          // the first chunk's offset in a stage
  int left;          // KC: rows left below the first; RC: depths left
  int fixed;         // KC: depths left at k-tile 0; RC: elements in range

  __device__ __forceinline__ TileLoader(const T* src, long long sr,
                                        long long sk, int R, int K,
                                        int r0) {
    const int row = threadIdx.x / CPR, c = (threadIdx.x % CPR) * E;
    base = src;
    soff = row * LD + c;
    if (KC) {
      p = src + (long long)(r0 + row) * sr + c;
      jstep = JSTEP * sr;
      kstep = GK;
      left = R - r0 - row;
      fixed = K - c;
    } else {
      p = src + (long long)row * sk + r0 + c;
      jstep = JSTEP * sk;
      kstep = GK * sk;
      left = K - row;
      const int n = R - r0 - c;
      fixed = n < 0 ? 0 : (n > E ? E : n);
    }
  }

  __device__ __forceinline__ void copy(T* stage, int kt) const {
    const int k0 = kt * GK;
    const T* pk = p + kt * kstep;
    int n = 0;
    if (KC) {
      n = fixed - k0;
      n = n < 0 ? 0 : (n > E ? E : n);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int elems = KC ? (j * JSTEP < left ? n : 0)
                           : (j * JSTEP < left - k0 ? fixed : 0);
      cp_async16(stage + soff + j * JSTEP * LD, elems ? pk + j * jstep : base,
                 elems * (int)sizeof(T));
    }
  }
};

// element (r, k) of a staged tile
template <typename T, bool KC>
__device__ __forceinline__ float tile_at(const T* s, int r, int k) {
  return to_f<T>(KC ? s[r * GemmTile<T>::LDK + k]
                    : s[k * GemmTile<T>::LDR + r]);
}

// One k-tile of the warp's 32 × 32 share on the tensor cores, fp32 by
// 3xTF32: big += A_big·B_big and small += A_small·B_big + A_big·B_small
// over the tile's 32 depths. The small terms, ~2⁻¹¹ of the big, go to
// their own accumulators, so the big chain takes one rounding of the
// tensor cores' accumulation per 8 depths and the small chain's roundings
// are ~2⁻¹¹ smaller.
template <bool AKC, bool BKC>
__device__ __forceinline__ void ktile_mma(const float* As, const float* Bs,
                                          int wm, int wn, float big[2][4][4],
                                          float small[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < GK / 8; ++ks) {
    uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(tile_at<float, AKC>(As, wm + mt * 16 + g + (e & 1) * 8,
                                       ks * 8 + t + (e >> 1) * 4),
                   ab[mt][e], as[mt][e]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_tf32(
            tile_at<float, BKC>(Bs, wn + nt * 8 + g, ks * 8 + t + e * 4),
            bb[nt][e], bs[nt][e]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(small[mt][nt], as[mt], bb[nt]);
        mma_tf32(small[mt][nt], ab[mt], bs[nt]);
        mma_tf32(big[mt][nt], ab[mt], bb[nt]);
      }
  }
}

// The same in bf16: ldmatrix fragments (.trans where the tile's contiguous
// axis is not the fragment's pair axis), m16n8k16 products.
template <bool AKC, bool BKC>
__device__ __forceinline__ void ktile_mma(const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs, int wm,
                                          int wn, float acc[2][4][4]) {
  using G = GemmTile<__nv_bfloat16>;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, j = lane & 7;
#pragma unroll
  for (int ks = 0; ks < GK / 16; ++ks) {
    const int kk = ks * 16;
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rm = wm + mt * 16;
      if (AKC)
        ldsm_x4(a[mt],
                As + (rm + (lane & 15)) * G::LDK + kk + (lane >> 4) * 8);
      else
        ldsm_x4_t(a[mt], As + (kk + (mi >> 1) * 8 + j) * G::LDR + rm +
                             (mi & 1) * 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int nn = wn + np * 16;
      uint32_t r[4];
      if (BKC)
        ldsm_x4(r, Bs + (nn + (mi >> 1) * 8 + j) * G::LDK + kk + (mi & 1) * 8);
      else
        ldsm_x4_t(r, Bs + (kk + (mi & 1) * 8 + j) * G::LDR + nn +
                         (mi >> 1) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
  }
}

// C[m0:m0+64, n0:n0+64] = Σ_k A(r, k) B(n, k) over k < K, the (M × K) A
// and (N × K) B given as element (r, k) at a[r·asr + k·ask] (one of the two
// strides is 1: AKC when ask is). Thread results in acc[mt][nt][e] at row
// m0 + wm + 16mt + g + 8(e/2), column n0 + wn + 8nt + 2t + e%2 (the C
// fragments), wm = 32·(warp / 2), wn = 32·(warp % 2).
template <typename T, bool AKC, bool BKC>
__device__ __forceinline__ void gemm_tile(T* smem, const T* a, long long asr,
                                          long long ask, int M, const T* b,
                                          long long bsr, long long bsk, int N,
                                          int K, int m0, int n0,
                                          float acc[2][4][4]) {
  using G = GemmTile<T>;
  constexpr bool F32 = sizeof(T) == 4;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int nk = (K + GK - 1) / GK;
  // k-tile kt into stage kt % GEMM_STAGES; one commit group per k-tile
  // (empty past the end), so that wait<GEMM_STAGES − 2> means "kt landed"
  const TileLoader<T, AKC> la(a, asr, ask, M, K, m0);
  const TileLoader<T, BKC> lb(b, bsr, bsk, N, K, n0);
  auto stage = [&](int kt) {
    if (kt < nk) {
      T* s = smem + 2 * (kt % GEMM_STAGES) * G::STAGE;
      la.copy(s, kt);
      lb.copy(s + G::STAGE, kt);
    }
    cp_async_commit();
  };
  for (int kt = 0; kt < GEMM_STAGES - 1; ++kt) stage(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GEMM_STAGES - 2>();
    // every warp is done with k-tile kt − 1, whose stage the next copies
    // fill
    __syncthreads();
    stage(kt + GEMM_STAGES - 1);
    const T* As = smem + 2 * (kt % GEMM_STAGES) * G::STAGE;
    const T* Bs = As + G::STAGE;
    if constexpr (F32) {
      // the k-tile's sums, added into acc in fp32 round-to-nearest
      float big[2][4][4], small[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            big[mt][nt][e] = small[mt][nt][e] = 0.f;
      ktile_mma<AKC, BKC>(As, Bs, wm, wn, big, small);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] += big[mt][nt][e] + small[mt][nt][e];
    } else {
      ktile_mma<AKC, BKC>(As, Bs, wm, wn, acc);
    }
  }
}

// gemm_tile with the two orientations chosen at run time
template <typename T>
__device__ __forceinline__ void gemm_any(T* smem, const T* a, long long asr,
                                         long long ask, int M, const T* b,
                                         long long bsr, long long bsk, int N,
                                         int K, int m0, int n0,
                                         float acc[2][4][4]) {
  if (ask == 1) {
    if (bsk == 1)
      gemm_tile<T, true, true>(smem, a, asr, ask, M, b, bsr, bsk, N, K, m0,
                               n0, acc);
    else
      gemm_tile<T, true, false>(smem, a, asr, ask, M, b, bsr, bsk, N, K, m0,
                                n0, acc);
  } else {
    if (bsk == 1)
      gemm_tile<T, false, true>(smem, a, asr, ask, M, b, bsr, bsk, N, K, m0,
                                n0, acc);
    else
      gemm_tile<T, false, false>(smem, a, asr, ask, M, b, bsr, bsk, N, K, m0,
                                 n0, acc);
  }
}

// Calls f(row, col, value) for each in-range element of the block's tile.
template <typename F>
__device__ __forceinline__ void for_tile(const float acc[2][4][4], int m0,
                                         int n0, int M, int N, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = m0 + (warp >> 1) * 32 + (lane >> 2);
  const int c0 = n0 + (warp & 1) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + mt * 16 + (e >> 1) * 8, c = c0 + nt * 8 + (e & 1);
        if (r < M && c < N) f(r, c, acc[mt][nt][e]);
      }
}

// grid (ceil(Lk/64), ceil(Lq/64), 2·B·H): z = 2·(b·H + h) + product.
// S (product 0) and dP (product 1) are (B·H, Lq, lds) fp32 in the scratch.
template <typename T>
__global__ void __launch_bounds__(GNT) head_bwd_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, float* __restrict__ scores, int heads, int lq,
    int lk, int d, int lds, Strides qs, Strides ks, Strides vs, Strides gs) {
  extern __shared__ float4 smem[];  // GemmTile<T>::SMEM bytes
  const int bh = blockIdx.z >> 1, job = blockIdx.z & 1;
  const int b = bh / heads, h = bh - b * heads;
  const Strides as = job ? gs : qs, bs = job ? vs : ks;
  const T* a = (job ? g : q) + b * as.b + h * as.h;
  const T* bp = (job ? v : k) + b * bs.b + h * bs.h;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GM;
  float acc[2][4][4];
  gemm_any<T>(reinterpret_cast<T*>(smem), a, as.l, as.d, lq, bp, bs.l, bs.d,
              lk, d, m0, n0, acc);
  const size_t plane = (size_t)(gridDim.z >> 1) * lq * lds;
  float* out = scores + job * plane + (size_t)bh * lq * lds;
  for_tile(acc, m0, n0, lq, lk,
           [&](int r, int c, float x) { out[(size_t)r * lds + c] = x; });
}

// One warp per query row of the (B·H·Lq, lds) score rows, four columns a
// lane at a time (lds is a multiple of 8, so every row is 32-byte aligned
// and the columns from Lk to lds are padding): m = max(s·scale),
// l = Σ e with e = exp(s·scale − m), δ = Σ e·dP / l (= Σ P·dP); then
// P = e / l, and P̃ = P and dS = P·(dP − δ), each rounded to T.
template <typename T>
__global__ void __launch_bounds__(32 * ROW_WARPS) head_bwd_rows_kernel(
    const float* __restrict__ scores, T* __restrict__ pt, T* __restrict__ ds,
    int rows, int lk, int lds, float scale) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t plane = (size_t)rows * lds;
  const float4* s4 = reinterpret_cast<const float4*>(scores + (size_t)row * lds);
  const float4* dp4 = reinterpret_cast<const float4*>(
      scores + plane + (size_t)row * lds);
  const int n4 = (lk + 3) >> 2;
  auto lanes = [&](float4 v, int j4, float pad) {
    const int j = 4 * j4;
    return make_float4(v.x * scale, j + 1 < lk ? v.y * scale : pad,
                       j + 2 < lk ? v.z * scale : pad,
                       j + 3 < lk ? v.w * scale : pad);
  };
  float m = -INFINITY;
  for (int j4 = lane; j4 < n4; j4 += 32) {
    const float4 x = lanes(s4[j4], j4, -INFINITY);
    m = fmaxf(m, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, edp = 0.f;
  for (int j4 = lane; j4 < n4; j4 += 32) {
    const float4 x = lanes(s4[j4], j4, -INFINITY);
    const float4 d = dp4[j4];
    const float e0 = expf(x.x - m), e1 = expf(x.y - m), e2 = expf(x.z - m),
                e3 = expf(x.w - m);
    l += (e0 + e1) + (e2 + e3);
    edp += (e0 * d.x + e1 * (e1 > 0.f ? d.y : 0.f)) +
           (e2 * (e2 > 0.f ? d.z : 0.f) + e3 * (e3 > 0.f ? d.w : 0.f));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
    edp += __shfl_xor_sync(0xffffffffu, edp, o);
  }
  const float delta = edp / l;
  T* pr = pt + (size_t)row * lds;
  T* dr = ds + (size_t)row * lds;
  for (int j4 = lane; j4 < n4; j4 += 32) {
    const float4 x = lanes(s4[j4], j4, -INFINITY);
    const float4 d = dp4[j4];
    const float p[4] = {expf(x.x - m) / l, expf(x.y - m) / l,
                        expf(x.z - m) / l, expf(x.w - m) / l};
    const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {   // the padding columns get 0
      pr[4 * j4 + u] = from_f<T>(p[u]);
      dr[4 * j4 + u] = from_f<T>(p[u] > 0.f ? p[u] * (dd[u] - delta) : 0.f);
    }
  }
}

// grid (ceil(D/64), ceil(max(Lq, Lk)/64), 3·B·H): z = 3·(b·H + h) + product,
// product 0 dQ = dS·K·scale, 1 dK = dSᵀ·Q·scale, 2 dV = P̃ᵀ·g. dS and P̃
// are (B·H, Lq, lds) in T.
template <typename T>
__global__ void __launch_bounds__(GNT) head_bwd_products_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ g,
    const T* __restrict__ pt, const T* __restrict__ ds, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int heads, int lq, int lk, int d,
    int lds, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  extern __shared__ float4 smem[];  // GemmTile<T>::SMEM bytes
  const int bh = blockIdx.z / 3, job = blockIdx.z - 3 * bh;
  const int b = bh / heads, h = bh - b * heads;
  const int M = job ? lk : lq, K = job ? lq : lk;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GM;
  if (m0 >= M) return;
  const size_t at = (size_t)bh * lq * lds;
  // A (r, k): dS rows (dQ) or columns (dK: dSᵀ, dV: P̃ᵀ) of the scratch
  const T* a = (job == 2 ? pt : ds) + at;
  const long long asr = job ? 1 : lds, ask = job ? lds : 1;
  // B (n = column of D, k): K for dQ, Q for dK, g for dV
  const Strides bs = job == 0 ? ks : (job == 1 ? qs : gs);
  const T* bp = (job == 0 ? k : (job == 1 ? q : g)) + b * bs.b + h * bs.h;
  float acc[2][4][4];
  gemm_any<T>(reinterpret_cast<T*>(smem), a, asr, ask, M, bp, bs.d, bs.l, d,
              K, m0, n0, acc);
  const Strides os = job == 0 ? qs : (job == 1 ? ks : vs);
  T* out = (job == 0 ? dq : (job == 1 ? dk : dv)) + b * os.b + h * os.h;
  const float mult = job == 2 ? 1.f : scale;
  for_tile(acc, m0, n0, M, d, [&](int r, int c, float x) {
    out[r * os.l + c * os.d] = from_f<T>(x * mult);
  });
}

// Row stride of the score scratch: Lk rounded up to 8 elements, so that
// every scratch row starts 16-byte aligned in fp32 and in bf16.
__host__ __device__ constexpr int scratch_ld(int lk) { return (lk + 7) & ~7; }

template <typename T>
static cudaError_t launch_head_bwd(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, void* scratch, int b,
                                   int h, int lq, int lk, int d,
                                   const Strides* st, float scale,
                                   cudaStream_t stream) {
  const int bh = b * h, lds = scratch_ld(lk);
  const size_t plane = (size_t)bh * lq * lds;
  float* scores = (float*)scratch;  // S, then dP
  T* pt = (T*)(scores + 2 * plane);
  T* ds = pt + plane;
  constexpr int smem = GemmTile<T>::SMEM;
  static SmemLimit limit_s, limit_p;
  cudaError_t err = limit_s.raise(head_bwd_scores_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = limit_p.raise(head_bwd_products_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 g1((lk + GM - 1) / GM, (lq + GM - 1) / GM, 2 * bh);
  head_bwd_scores_kernel<T><<<g1, GNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, scores, h, lq, lk, d,
      lds, st[0], st[1], st[2], st[3]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = bh * lq;
  head_bwd_rows_kernel<T><<<(rows + ROW_WARPS - 1) / ROW_WARPS,
                            32 * ROW_WARPS, 0, stream>>>(scores, pt, ds, rows,
                                                         lk, lds, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int lmax = lq > lk ? lq : lk;
  dim3 g3((d + GM - 1) / GM, (lmax + GM - 1) / GM, 3 * bh);
  head_bwd_products_kernel<T><<<g3, GNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)g, pt, ds, (T*)dq, (T*)dk, (T*)dv,
      h, lq, lk, d, lds, st[0], st[1], st[2], st[3], scale);
  return cudaGetLastError();
}

}  // namespace dft

// q and g (b, h, lq, d), k and v (b, h, lk, d), each with its own strides
// in elements (batch, head, row, column): strides[0:4] q's (and dq's),
// [4:8] k's (and dk's), [8:12] v's (and dv's), [12:16] g's. Each operand
// has stride 1 along its rows or its columns, its other strides and its
// address are multiples of 16 bytes. scratch holds 2·b·h·lq·lds fp32 and
// then 2·b·h·lq·lds operand elements, lds = lk rounded up to 8. Operands of
// one dtype (DTYPE_F32 or DTYPE_BF16); head dims 512 and 32. Returns the
// cudaError_t of the launches; 1 (cudaErrorInvalidValue) for arguments it
// does not take.
extern "C" int dft_attn_bwd(const void* q, const void* k, const void* v,
                            const void* g, void* dq, void* dk, void* dv,
                            void* scratch, int b, int h, int lq, int lk,
                            int d, long long qsb, long long qsh, long long qsl,
                            long long qsd, long long ksb, long long ksh,
                            long long ksl, long long ksd, long long vsb,
                            long long vsh, long long vsl, long long vsd,
                            long long gsb, long long gsh, long long gsl,
                            long long gsd, float scale, int dtype,
                            void* stream) {
  if (b < 1 || h < 1 || lq < 1 || lk < 1 || (d != 512 && d != 32))
    return (int)cudaErrorInvalidValue;
  const dft::Strides st[4] = {{qsb, qsh, qsl, qsd},
                              {ksb, ksh, ksl, ksd},
                              {vsb, vsh, vsl, vsd},
                              {gsb, gsh, gsl, gsd}};
  for (const auto& s : st)
    if (s.l != 1 && s.d != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dft::DTYPE_F32)
    return (int)dft::launch_head_bwd<float>(q, k, v, g, dq, dk, dv, scratch,
                                            b, h, lq, lk, d, st, scale, s);
  if (dtype == dft::DTYPE_BF16)
    return (int)dft::launch_head_bwd<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, scratch, b, h, lq, lk, d, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
