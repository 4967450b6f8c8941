// The tile GEMM of the per-head attention kernels (attention_head_fwd.cu,
// and head_bwd.cuh's backward of attention_head_bwd.cu and attention_bwd.cu)
// on Hopper's tensor cores.
//
// gemm_tile computes one 64×64 block tile of C = A·Bᵀ over any depth K:
// 32-deep k-tiles copied global → shared by 16-byte cp.async, GEMM_STAGES
// of them in flight, four warps of 32×32 on mma.sync. An operand tile keeps
// the orientation it has in memory: "k-contiguous" ([r][k], e.g. row-major
// Q along D) or "r-contiguous" ([k][r], e.g. the VAE's NCHW token views,
// stride 1 along L, or a transposed score matrix); fragment loads read
// either, and the row padding (fp32: 36 or 72 floats, bf16: 40 or 72
// elements) keeps them free of bank conflicts. bf16 operands go through
// ldmatrix (.trans where the tile's contiguous axis is not the fragment's
// pair axis) into m16n8k16 products. fp32 operands use 3xTF32: each element
// is split into big + small TF32 parts and three m16n8k8 products
// (small·big, big·small, big·big) keep fp32 accuracy at up to a third of
// the TF32 rate. The tensor cores' fp32 sums lose accuracy along a chain of
// products, so the small terms get accumulators of their own and each
// k-tile's sums are added into separate fp32 registers: a chain spans 32
// depths.
//
// Both kernels keep score rows in a scratch the wrapper allocates, with
// rows of scratch_ld(Lk) elements.
#pragma once

#include "mma.cuh"

namespace dft {

// an operand's strides in elements: batch, head, row (L), column (D)
struct Strides {
  long long b, h, l, d;
};

constexpr int GM = 64;    // block tile rows (M) and columns (N)
constexpr int GK = 32;    // k-tile depth
constexpr int GNT = 128;  // four warps, 2 × 2 warp tiles of 32 × 32
constexpr int GEMM_STAGES = 3;  // k-tiles in flight
constexpr int ROW_WARPS = 8;  // score rows (one a warp) per block of a row pass

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
// are ~2⁻¹¹ smaller. PRECISE takes each 8-deep product into fresh
// accumulators and adds it into big and small in fp32 round-to-nearest
// (the tensor cores' own accumulation then never carries a sum), with
// the small parts rounded onto TF32 (split_tf32<true>).
template <bool AKC, bool BKC, bool PRECISE>
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
        split_tf32<PRECISE>(
            tile_at<float, AKC>(As, wm + mt * 16 + g + (e & 1) * 8,
                                ks * 8 + t + (e >> 1) * 4),
            ab[mt][e], as[mt][e]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_tf32<PRECISE>(
            tile_at<float, BKC>(Bs, wn + nt * 8 + g, ks * 8 + t + e * 4),
            bb[nt][e], bs[nt][e]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if constexpr (PRECISE) {
          float tb[4] = {0.f, 0.f, 0.f, 0.f}, ts[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(ts, as[mt], bb[nt]);
          mma_tf32(ts, ab[mt], bs[nt]);
          mma_tf32(tb, ab[mt], bb[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            big[mt][nt][e] = __fadd_rn(big[mt][nt][e], tb[e]);
            small[mt][nt][e] = __fadd_rn(small[mt][nt][e], ts[e]);
          }
        } else {
          mma_tf32(small[mt][nt], as[mt], bb[nt]);
          mma_tf32(small[mt][nt], ab[mt], bs[nt]);
          mma_tf32(big[mt][nt], ab[mt], bb[nt]);
        }
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
// fragments), wm = 32·(warp / 2), wn = 32·(warp % 2). In fp32 with PRECISE
// (ktile_mma's) the k-tiles' sums are added into acc with a compensation
// term (Kahan), so acc carries the whole depth to about one rounding.
template <typename T, bool AKC, bool BKC, bool PRECISE = false>
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
  float comp[2][4][4];   // PRECISE: acc's lost low-order parts
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) comp[mt][nt][e] = 0.f;
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
      ktile_mma<AKC, BKC, PRECISE>(As, Bs, wm, wn, big, small);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& a = acc[mt][nt][e];
            if constexpr (PRECISE) {
              const float y = __fsub_rn(
                  __fadd_rn(big[mt][nt][e], small[mt][nt][e]),
                  comp[mt][nt][e]);
              const float sum = __fadd_rn(a, y);
              comp[mt][nt][e] = __fsub_rn(__fsub_rn(sum, a), y);
              a = sum;
            } else {
              a += big[mt][nt][e] + small[mt][nt][e];
            }
          }
    } else {
      ktile_mma<AKC, BKC>(As, Bs, wm, wn, acc);
    }
  }
}

// gemm_tile with the two orientations chosen at run time
template <typename T, bool PRECISE = false>
__device__ __forceinline__ void gemm_any(T* smem, const T* a, long long asr,
                                         long long ask, int M, const T* b,
                                         long long bsr, long long bsk, int N,
                                         int K, int m0, int n0,
                                         float acc[2][4][4]) {
  if (ask == 1) {
    if (bsk == 1)
      gemm_tile<T, true, true, PRECISE>(smem, a, asr, ask, M, b, bsr, bsk, N,
                                        K, m0, n0, acc);
    else
      gemm_tile<T, true, false, PRECISE>(smem, a, asr, ask, M, b, bsr, bsk, N,
                                         K, m0, n0, acc);
  } else {
    if (bsk == 1)
      gemm_tile<T, false, true, PRECISE>(smem, a, asr, ask, M, b, bsr, bsk, N,
                                         K, m0, n0, acc);
    else
      gemm_tile<T, false, false, PRECISE>(smem, a, asr, ask, M, b, bsr, bsk,
                                          N, K, m0, n0, acc);
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

// The block's 64×64 tile of S = A·Bᵀ for one (batch, head): A (Lq, D) and
// B (Lk, D) with their row and column strides, depth D; written in fp32
// into score rows of lds elements at out. Tile (blockIdx.y, blockIdx.x).
template <typename T, bool PRECISE = false>
__device__ __forceinline__ void score_tile(T* smem, const T* a, Strides as,
                                           const T* b, Strides bs, int lq,
                                           int lk, int d, float* out,
                                           int lds) {
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GM;
  float acc[2][4][4];
  gemm_any<T, PRECISE>(smem, a, as.l, as.d, lq, b, bs.l, bs.d, lk, d, m0,
                       n0, acc);
  // each pair of neighbouring columns as one 8-byte store (lds is a
  // multiple of 8, so a pair starting before lk ends inside the row; a
  // column past lk is padding, which every reader masks)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = m0 + (warp >> 1) * 32 + (lane >> 2);
  const int c0 = n0 + (warp & 1) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + mt * 16 + h * 8, c = c0 + nt * 8;
        if (r < lq && c < lk)
          *reinterpret_cast<float2*>(out + (size_t)r * lds + c) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// Scores 4·j4 .. 4·j4 + 3 of a row times scale; the columns at or past lk
// (the padding of the row's last float4) give −inf.
__device__ __forceinline__ float4 scaled4(float4 v, int j4, int lk,
                                          float scale) {
  const int j = 4 * j4;
  return make_float4(v.x * scale, j + 1 < lk ? v.y * scale : -INFINITY,
                     j + 2 < lk ? v.z * scale : -INFINITY,
                     j + 3 < lk ? v.w * scale : -INFINITY);
}

// max(s·scale) over a score row of n4 float4s, read by one warp (lane
// j4 % 32 takes float4 j4); every lane gets the result.
__device__ __forceinline__ float row_max(const float4* s4, int n4, int lk,
                                         float scale) {
  float m = -INFINITY;
  for (int j4 = threadIdx.x & 31; j4 < n4; j4 += 32) {
    const float4 x = scaled4(s4[j4], j4, lk, scale);
    m = fmaxf(m, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Row stride of the score scratch: Lk rounded up to 8 elements, so that
// every scratch row starts 16-byte aligned in fp32 and in bf16.
__host__ __device__ constexpr int scratch_ld(int lk) { return (lk + 7) & ~7; }

}  // namespace dft
