// Packed-heads softmax attention forward for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_packed_kernel
// (launched by _pallas_forward_packed, entry flash_attention_packed):
//   O[b, i, h·D:(h+1)·D] = softmax(Q_h K_hᵀ · scale) V_h
// over packed (B, L, H·D) operands, no mask.
//
// Numerics follow the TPU kernel: fp32 scores times scale, row max,
// P = e / Σe in fp32, P cast to V's type, fp32 P·V, output cast back.
// To keep that order exactly (normalise, then cast) a block makes two
// passes over the keys: the first finds each row's max and sum, the
// second forms the normalised P and accumulates P·V.
//
// Bound on this card: 4·B·H·Lq·Lk·D operations against (2·Lq + 2·Lk)·B·H·D
// operand elements. Against the card's ~295 bf16 operations per byte only
// Lq = Lk = 1024 (the UNet's level-0 self-attention) is operation-bound;
// every other path shape is byte-bound.
//
// bf16, the paths' type (attn_packed_fwd_mma_kernel): one block of
// FWD_WARPS warps per (16·FWD_WARPS query rows, head, batch), 16 rows a
// warp. The Q fragments
// stay in registers for the whole block. Key and value tiles of 64 rows go
// straight from the packed rows into shared memory in bf16 by 16-byte
// cp.async, FWD_STAGES tiles in flight (a head's columns start h·D·2 bytes
// into a row: 16-byte aligned at D 32, 40, 48, 64, 80, 96, 160). Both passes compute
// S = Q Kᵀ on mma.sync.m16n8k16 (K fragments by ldmatrix; D 40 pads the
// depth to 48 with zero columns, which add exactly 0). Pass 1 keeps the
// row max and sum in the accumulators' registers; pass 2 forms
// P = exp(s·scale − m)/l in fp32 (as 2^(x − m₂)·(1/l), x the score in the
// log2 domain, on the special-function unit), rounds it to bf16 and feeds
// it to the P·V product straight from the registers (two m16n8 C
// fragments are one m16n8k16 A fragment), V fragments by ldmatrix.trans.
// The output is rounded to bf16 once. Rows past Lq or Lk are zero-filled
// and masked.
//
// fp32 (attn_packed_fwd_kernel) runs the fp32 classifier, the 1-D audio
// UNet, EncoderUNetModel and the AR cond encoder, and the GPU-vs-CPU
// agreement of tiny pipelines: fp32 FMAs from shared memory, tiles staged as fp32, each row's
// sum compensated and brought to the row max in fp64 once
// (attention_common.cuh::row_stats); correct and simple, not fast.
#include "attention_common.cuh"
#include "mma.cuh"

namespace dft {

// grid (ceil(Lq/BQ), H, B), NT threads
template <typename T, int NC>
__global__ void __launch_bounds__(NT, fwd_min_blocks(NC))
    attn_packed_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int lq, int lk, int heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(d);
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;  // (BQ, SLD)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * d;
  const int col0 = h * d;
  const T* qb = q + (size_t)b * lq * hd;
  const T* kb = k + (size_t)b * lk * hd;
  const T* vb = v + (size_t)b * lk * hd;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T>(Qs, ld, qb, q0, BQ, lq, hd, col0, d);
  float m[4], l[4];
  row_stats<T>(Qs, Ks, kb, lk, hd, col0, d, scale, m, l);

  float acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();
    load_tile<T>(Ks, ld, kb, k0, BK, lk, hd, col0, d);
    load_tile<T>(Vs, ld, vb, k0, BK, lk, hd, col0, d);
    __syncthreads();
    float s[4][4];
    tile_abt(Qs, Ks, ld, d, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = tx + 16 * bb;
        const float p =
            k0 + j < lk ? expf(s[a][bb] * scale - m[a]) / l[a] : 0.f;
        Ps[(ty + 16 * a) * SLD + j] = round_as<T>(p);
      }
    __syncthreads();
    const int n = lk - k0 < BK ? lk - k0 : BK;
    acc_pv<NC>(Ps, false, Vs, ld, d, n, acc);
  }

  const int r = threadIdx.x >> 2;
  const int cg = threadIdx.x & 3;
  if (q0 + r < lq) {
    T* orow = o + ((size_t)b * lq + q0 + r) * hd + col0;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = cg + 4 * u;
      if (c < d) orow[c] = from_f<T>(acc[u]);
    }
  }
}

constexpr int FWD_WARPS = 4;            // warps of the bf16 kernel
constexpr int FNT = 32 * FWD_WARPS;      // its threads
constexpr int FQ = 16 * FWD_WARPS;       // its query rows: 16 a warp
constexpr int FWD_STAGES = 2;            // key (and value) tiles in flight

template <int D>
struct FwdTile {
  static constexpr int DP = (D + 15) / 16 * 16;  // Q·Kᵀ depth, zero-padded
  static constexpr int LD = DP + 8;     // row pitch: an odd multiple of 16 B
  static constexpr int TILE = BK * LD;  // elements of one 64-row key tile
  static constexpr int SMEM = (FQ * LD + 2 * FWD_STAGES * TILE) * 2;
};

// The thread's share of the 16-byte copies of ROWS rows of one head (its D
// columns) of a packed (L, H·D) bf16 slab into a tile of pitch LD: chunk
// tid + FNT·u (u < NU) is row idx / (D/8), column 8·(idx % (D/8)). The
// offsets are set up once; a copy adds the tile's first row.
template <int D, int ROWS>
struct HeadRowCopies {
  static constexpr int CH = D / 8;
  static constexpr int NU = (ROWS * CH + FNT - 1) / FNT;
  int soff[NU];  // offset in the tile
  int goff[NU];  // offset in the slab from the tile's first row
  int row[NU];   // tile row; ROWS for a chunk past the tile

  __device__ __forceinline__ HeadRowCopies(int hd, int col0) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = threadIdx.x + FNT * u;
      const int r = idx / CH, c = idx - r * CH;
      soff[u] = r * FwdTile<D>::LD + c * 8;
      goff[u] = r * hd + col0 + c * 8;
      row[u] = idx < ROWS * CH ? r : ROWS;
    }
  }

  // rows row0 .. row0 + ROWS of src into dst; rows ≥ L are zero
  __device__ __forceinline__ void copy(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int row0,
                                       int L, int hd) const {
    const __nv_bfloat16* base = src + (size_t)row0 * hd;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (row[u] < ROWS) {
        const bool ok = row[u] < L - row0;
        cp_async16(dst + soff[u], ok ? base + goff[u] : src, ok ? 16 : 0);
      }
    }
  }
};

// 2^x on the special-function unit (flushes results below 2⁻¹²⁶ to 0: such
// a P is 0 after the bf16 rounding of the output)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// grid (ceil(Lq/FQ), H, B), FNT threads, FwdTile<D>::SMEM bytes
template <int D>
__global__ void __launch_bounds__(FNT) attn_packed_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int lq, int lk, int heads, float scale) {
  using F = FwdTile<D>;
  constexpr int DP = F::DP, LD = F::LD, KS = DP / 16, NO = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + FQ * LD;               // FWD_STAGES tiles
  __nv_bfloat16* Vs = Ks + FWD_STAGES * F::TILE;  // FWD_STAGES tiles

  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * D;
  const int col0 = h * D;
  const __nv_bfloat16* qb = q + (size_t)b * lq * hd;
  const __nv_bfloat16* kb = k + (size_t)b * lk * hd;
  const __nv_bfloat16* vb = v + (size_t)b * lk * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = lane >> 3, j = lane & 7, t = lane & 3;

  // the depth padding D .. DP of Q and every K stage is zero
  if (DP > D) {
    for (int idx = threadIdx.x; idx < (FQ + FWD_STAGES * BK) * (DP - D);
         idx += FNT) {
      const int r = idx / (DP - D);
      Qs[r * LD + D + idx - r * (DP - D)] = __float2bfloat16(0.f);
    }
  }
  // tile i < n: pass 1 over key tile i; n ≤ i < 2n: pass 2 over tile i − n
  const int n = (lk + BK - 1) / BK;
  const HeadRowCopies<D, BK> kv(hd, col0);
  auto issue = [&](int i) {
    const int s = i % FWD_STAGES, k0 = (i < n ? i : i - n) * BK;
    kv.copy(Ks + s * F::TILE, kb, k0, lk, hd);
    if (i >= n) kv.copy(Vs + s * F::TILE, vb, k0, lk, hd);
    cp_async_commit();
  };
  HeadRowCopies<D, FQ>(hd, col0).copy(Qs, qb, q0, lq, hd);
  for (int i = 0; i < FWD_STAGES - 1; ++i) {
    if (i < 2 * n) issue(i);
    else cp_async_commit();   // an empty group keeps the count uniform
  }

  uint32_t qf[KS][4];
  const float sl2 = scale * 1.4426950408889634f;  // scale·log2(e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < 2 * n; ++i) {
    // tile i has landed; every warp is done with tile i − 1, whose buffer
    // the next copies fill
    cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();
    if (i + FWD_STAGES - 1 < 2 * n) issue(i + FWD_STAGES - 1);
    else cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (i % FWD_STAGES) * F::TILE;
    const int k0 = (i < n ? i : i - n) * BK;

    // S = Q Kᵀ for the warp's 16 rows × 64 keys: s[nt][e] at row
    // g + 8(e/2), key k0 + 8nt + 2t + e%2
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4(r, Kt + (np * 16 + (mi >> 1) * 8 + j) * LD + ks * 16 +
                       (mi & 1) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[2 * np], qf[ks], b0);
        mma_bf16(s[2 * np + 1], qf[ks], b1);
      }
    // scores in the log2 domain, x = s·scale·log2(e), so that
    // exp(s·scale − m) = 2^(x − m₂); keys past Lk (only in the last tile)
    // at −∞, whose exponential is 0
    const int kmax = lk - k0 - 2 * t;  // the thread's key 8nt + e%2 is
                                       // valid while below kmax
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= sl2;
    if (k0 + BK > lk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + (e & 1) >= kmax) s[nt][e] = -INFINITY;
    }

    if (i < n) {
      // pass 1: running max and sum of each of the thread's two rows
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hr], mx);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          sum += ex2(s[nt][2 * hr] - mn) + ex2(s[nt][2 * hr + 1] - mn);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * ex2(m[hr] - mn) + sum;
        m[hr] = mn;
      }
    } else {
      // pass 2: P = exp(s·scale − m)/l in fp32, rounded to bf16 as the
      // A fragments of P·V
      const __nv_bfloat16* Vt = Vs + (i % FWD_STAGES) * F::TILE;
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = ex2(s[nt][e] - m[e >> 1]) * inv[e >> 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, Vt + (kk * 16 + (mi & 1) * 8 + j) * LD + dp * 16 +
                           (mi >> 1) * 8);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(acc[2 * dp], a, b0);
          mma_bf16(acc[2 * dp + 1], a, b1);
        }
        if (NO & 1) {
          uint32_t r[2];
          ldsm_x2_t(r, Vt + (kk * 16 + (mi & 1) * 8 + j) * LD + (NO - 1) * 8);
          mma_bf16(acc[NO - 1], a, r);
        }
      }
    }
  }

  // the output, rounded to bf16 once
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + warp * 16 + (lane >> 2) + 8 * hr;
    if (r < lq) {
      __nv_bfloat16* orow = o + ((size_t)b * lq + r) * hd + col0 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        *reinterpret_cast<uint32_t*>(orow + nt * 8) =
            pack_bf16(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    }
  }
}

template <int D>
static cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                                  void* o, int b, int lq, int lk, int heads,
                                  float scale, cudaStream_t stream) {
  auto kernel = attn_packed_fwd_mma_kernel<D>;
  static SmemLimit limit;
  cudaError_t err = limit.raise(kernel, FwdTile<D>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + FQ - 1) / FQ, heads, b);
  kernel<<<grid, FNT, FwdTile<D>::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lq, lk, heads, scale);
  return cudaGetLastError();
}

template <typename T, int NC>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              void* o, int b, int lq, int lk, int heads, int d,
                              float scale, cudaStream_t stream) {
  const int ld = tile_ld(d);
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * ld + BQ * SLD);
  auto kernel = attn_packed_fwd_kernel<T, NC>;
  static SmemLimit limit;   // d = 4·NC, so smem is fixed per instantiation
  cudaError_t err = limit.raise(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, heads, b);
  kernel<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                     (T*)o, lq, lk, heads, d, scale);
  return cudaGetLastError();
}

}  // namespace dft

// q (b, lq, heads·d), k and v (b, lk, heads·d), o like q; all contiguous,
// 16-byte aligned, of one dtype (DTYPE_F32 or DTYPE_BF16). Returns the cudaError_t of the
// launch; 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int dft_attn_packed_fwd(const void* q, const void* k, const void* v,
                                   void* o, int b, int lq, int lk, int heads,
                                   int d, float scale, int dtype,
                                   void* stream) {
  if (b < 1 || lq < 1 || lk < 1 || heads < 1 || !dft::supported_head_dim(d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == dft::DTYPE_F32) {
    DFT_DISPATCH_NC(d, err = dft::launch_fwd<float, NC>(q, k, v, o, b, lq, lk,
                                                        heads, d, scale, s));
  } else if (dtype == dft::DTYPE_BF16) {
    DFT_DISPATCH_NC(d, err = dft::launch_fwd_mma<4 * NC>(q, k, v, o, b, lq,
                                                          lk, heads, scale,
                                                          s));
  }
  return (int)err;
}
