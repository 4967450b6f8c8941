// Per-head softmax attention forward over (B, H, L, D) for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_kernel (launched
// by _pallas_forward, entry flash_attention):
//   O[b, h] = softmax(Q[b, h] K[b, h]ᵀ · scale) V[b, h]
// no mask. The path runs it in the VAE's single-head mid attention
// (B, 1, 1024, 512), encoder and decoder, and the spec decoder's of
// train/stage2_decode.py at (B, 1, 16, 256); the diffusion prior's
// self-attention at (B, 8, 16, 64) and EncoderUNetModel's attention pool,
// one query against h·w + 1 keys at (B, 8, 1, 65, 32); the tiny agreement
// VAEs at D 32.
//
// Numerics are the TPU kernel's and the plain version's: fp32 scores times
// scale, row max, P = e / Σe in fp32, P rounded to V's type (P̃), then P̃·V
// summed in fp32 and rounded to the operand type.
//
// The TPU kernel holds one (batch·head)'s whole (Lq, Lk) score matrix in
// VMEM. Here the card's 50 MB L2 plays that role: the scores of one call
// live in a scratch the wrapper allocates, B·H·Lq·lds fp32 with lds = Lk
// rounded up to 8 (16 MB at (4, 1, 1024, 512)). Three launches, two
// products, nothing recomputed:
//   1. head_fwd_scores_kernel: S = Q·Kᵀ, one 64×64 tile per block, fp32
//      into the scratch.
//   2. head_fwd_rows_kernel, one warp per query row: m, l = Σ e, then
//      P̃ = e / l rounded to T, written over the row's own scores: P̃'s row
//      starts where S's does, lds·4 / sizeof(T) elements of T apart.
//   3. head_fwd_products_kernel: O = P̃·V, each output tile written once in
//      o's strides (q's: the NCHW token view or row-major).
// Normalising before the cast needs the whole row's l before any P̃·V sum,
// which a single online pass (rescaling the sums as the max moves) does
// not give; the row pass over a scratch in L2 keeps the plain version's
// order of roundings at the cost of one write and two reads of S.
//
// Both products are head_gemm.cuh's tile GEMM (mma.sync; bf16 through
// ldmatrix into m16n8k16, fp32 as 3xTF32), shared with the backward
// (attention_head_bwd.cu). Operands are read through their own strides in
// either dense layout.
//
// Bound on this card: 4·B·H·Lq·Lk·D operations (two products) against
// (2·Lq + 2·Lk)·B·H·D operand elements: operation-bound at L 1024, D 512,
// at 989 TFLOP/s in bf16 and 495/3 = 165 TFLOP/s for fp32-accurate 3xTF32
// (8.6 GFLOP at B 4: 8.7 µs in bf16, 52 µs in fp32). The products run on
// the tensor cores for that reason; the scratch traffic (S written, read
// twice, P̃ written and read: ~64 MB at the train shape) stays mostly in
// L2. wgmma and TMA would reach more of the rate; later work.
#include "head_gemm.cuh"

namespace dft {

// grid (ceil(Lk/64), ceil(Lq/64), B·H): S = Q·Kᵀ as (B·H, Lq, lds) fp32
template <typename T>
__global__ void __launch_bounds__(GNT) head_fwd_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ scores,
    int heads, int lq, int lk, int d, int lds, Strides qs, Strides ks) {
  extern __shared__ float4 smem[];  // GemmTile<T>::SMEM bytes
  const int bh = blockIdx.z;
  const int b = bh / heads, h = bh - b * heads;
  score_tile<T>(reinterpret_cast<T*>(smem), q + b * qs.b + h * qs.h, qs,
                k + b * ks.b + h * ks.h, ks, lq, lk, d,
                scores + (size_t)bh * lq * lds, lds);
}

// One warp per query row of the (B·H·Lq, lds) fp32 score rows:
// m = max(s·scale), l = Σ e with e = exp(s·scale − m), then P̃ = e / l
// rounded to T over the row itself (the padding columns of the last float4
// get 0). The last pass reads 32 float4s of the row into registers before
// any lane writes: in bf16 the P̃ of float4 j lands in float4 j / 2. (The
// row is read and written through one pointer, not __restrict__.)
template <typename T>
__global__ void __launch_bounds__(32 * ROW_WARPS) head_fwd_rows_kernel(
    float* scores, int rows, int lk, int lds, float scale) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float* sr = scores + (size_t)row * lds;
  const float4* s4 = reinterpret_cast<const float4*>(sr);
  const int n4 = (lk + 3) >> 2;
  const float m = row_max(s4, n4, lk, scale);
  float l = 0.f;
  for (int j4 = lane; j4 < n4; j4 += 32) {
    const float4 x = scaled4(s4[j4], j4, lk, scale);
    l += (expf(x.x - m) + expf(x.y - m)) + (expf(x.z - m) + expf(x.w - m));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  T* pr = reinterpret_cast<T*>(sr);
  for (int base = 0; base < n4; base += 32) {
    const int j4 = base + lane;
    const float4 x = j4 < n4 ? scaled4(s4[j4], j4, lk, scale)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();   // every lane has read its float4 before any writes
    if (j4 < n4) {
      const float p[4] = {expf(x.x - m) / l, expf(x.y - m) / l,
                          expf(x.z - m) / l, expf(x.w - m) / l};
#pragma unroll
      for (int u = 0; u < 4; ++u) pr[4 * j4 + u] = from_f<T>(p[u]);
    }
  }
}

// grid (ceil(D/64), ceil(Lq/64), B·H): O = P̃·V with P̃ (B·H, Lq, pld) in T
// over the scratch; each output tile written once in o's strides.
template <typename T>
__global__ void __launch_bounds__(GNT) head_fwd_products_kernel(
    const T* __restrict__ pt, const T* __restrict__ v, T* __restrict__ o,
    int heads, int lq, int lk, int d, int pld, Strides vs, Strides os) {
  extern __shared__ float4 smem[];  // GemmTile<T>::SMEM bytes
  const int bh = blockIdx.z;
  const int b = bh / heads, h = bh - b * heads;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GM;
  // A (r, k) = P̃ (query, key); B (n, k) = V (key, column of D) transposed
  float acc[2][4][4];
  gemm_any<T>(reinterpret_cast<T*>(smem), pt + (size_t)bh * lq * pld, pld, 1,
              lq, v + b * vs.b + h * vs.h, vs.d, vs.l, d, lk, m0, n0, acc);
  T* out = o + b * os.b + h * os.h;
  for_tile(acc, m0, n0, lq, d, [&](int r, int c, float x) {
    out[r * os.l + c * os.d] = from_f<T>(x);
  });
}

template <typename T>
static cudaError_t launch_head_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* scratch,
                                   int b, int h, int lq, int lk, int d,
                                   const Strides* st, float scale,
                                   cudaStream_t stream) {
  const int bh = b * h, lds = scratch_ld(lk);
  float* scores = (float*)scratch;
  constexpr int smem = GemmTile<T>::SMEM;
  static SmemLimit limit_s, limit_p;
  cudaError_t err = limit_s.raise(head_fwd_scores_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = limit_p.raise(head_fwd_products_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 g1((lk + GM - 1) / GM, (lq + GM - 1) / GM, bh);
  head_fwd_scores_kernel<T><<<g1, GNT, smem, stream>>>(
      (const T*)q, (const T*)k, scores, h, lq, lk, d, lds, st[0], st[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = bh * lq;
  head_fwd_rows_kernel<T><<<(rows + ROW_WARPS - 1) / ROW_WARPS,
                            32 * ROW_WARPS, 0, stream>>>(scores, rows, lk, lds,
                                                         scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g3((d + GM - 1) / GM, (lq + GM - 1) / GM, bh);
  head_fwd_products_kernel<T><<<g3, GNT, smem, stream>>>(
      (const T*)scores, (const T*)v, (T*)o, h, lq, lk, d,
      lds * (int)(sizeof(float) / sizeof(T)), st[2], st[3]);
  return cudaGetLastError();
}

}  // namespace dft

// q and o (b, h, lq, d), k and v (b, h, lk, d), each with its own strides
// in elements (batch, head, row, column): strides[0:4] q's, [4:8] k's,
// [8:12] v's, [12:16] o's. Each operand has stride 1 along its rows or its
// columns; q's, k's and v's other strides and addresses are multiples of
// 16 bytes. scratch holds b·h·lq·lds fp32, lds = lk rounded up to 8.
// Operands of one dtype (DTYPE_F32 or DTYPE_BF16); head dims 512, 256, 64
// and 32.
// Returns the cudaError_t of the launches; 1 (cudaErrorInvalidValue) for
// arguments it does not take.
extern "C" int dft_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, void* scratch, int b, int h, int lq,
                            int lk, int d, long long qsb, long long qsh,
                            long long qsl, long long qsd, long long ksb,
                            long long ksh, long long ksl, long long ksd,
                            long long vsb, long long vsh, long long vsl,
                            long long vsd, long long osb, long long osh,
                            long long osl, long long osd, float scale,
                            int dtype, void* stream) {
  if (b < 1 || h < 1 || lq < 1 || lk < 1 ||
      (d != 512 && d != 256 && d != 64 && d != 32))
    return (int)cudaErrorInvalidValue;
  const dft::Strides st[4] = {{qsb, qsh, qsl, qsd},
                              {ksb, ksh, ksl, ksd},
                              {vsb, vsh, vsl, vsd},
                              {osb, osh, osl, osd}};
  for (const auto& s : st)
    if (s.l != 1 && s.d != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dft::DTYPE_F32)
    return (int)dft::launch_head_fwd<float>(q, k, v, o, scratch, b, h, lq, lk,
                                            d, st, scale, s);
  if (dtype == dft::DTYPE_BF16)
    return (int)dft::launch_head_fwd<__nv_bfloat16>(q, k, v, o, scratch, b, h,
                                                    lq, lk, d, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
