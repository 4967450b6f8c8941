// The three launches of the per-head attention backward on Hopper's tensor
// cores, shared by the per-head entry (attention_head_bwd.cu, the VAE's
// (B, H, L, D) operands) and the packed entry (attention_bwd.cu, each head
// of a (B, L, H·D) operand read as the strided view (B, H, L, D) with
// strides (L·H·D, D, H·D, 1)). Given the saved q, k, v and the output
// gradient g of one (batch, head):
//   P  = softmax(Q Kᵀ · scale)                       (recomputed, fp32)
//   dV = P̃ᵀ g            with P̃ = P cast to g's type
//   dS = P ∘ (g Vᵀ − Σ_j (g Vᵀ ∘ P))  cast to q's type
//   dQ = dS K · scale,   dK = dSᵀ Q · scale
// with fp32 accumulation; dQ, dK and dV are returned in the operand type.
//
// The TPU kernels hold a query chunk's whole (Qc, Lk) score matrix in VMEM
// and run the five products on the MXU. Here the card's 50 MB L2 plays
// that role: the scores of one call live in a scratch buffer the wrapper
// allocates (B·H·Lq·Lk fp32 for S and for g Vᵀ, the same count in the
// operand type for P̃ and dS). Three launches, five products, nothing
// recomputed:
//   1. head_bwd_scores_kernel: S = Q Kᵀ and dP = g Vᵀ, one 64×64 tile and
//      one of the two products per block, fp32 into the scratch.
//   2. head_bwd_rows_kernel, one warp per query row: m, l, P = e/l in fp32,
//      δ = Σ_j P·dP (as Σ_j e·dP / l); writes P̃ and dS rounded to the
//      operand type (the plain version's roundings).
//   3. head_bwd_products_kernel: dQ = dS·K·scale, dK = dSᵀ·Q·scale and
//      dV = P̃ᵀ·g, blockIdx.z choosing the product; each output tile is
//      written once in q's, k's or v's strides. No atomics.
//
// Every product is one 64×64 tile of head_gemm.cuh's tile GEMM (mma.sync;
// fp32 as 3xTF32), shared with the per-head forward. fp32 over at most 32
// queries or under 8 keys runs three fp64 launches instead
// (fp64_backward). Its 16-byte copies
// zero-fill depths past D and rows past L, so any D works (a packed head
// of D 40 reads exactly its 40 columns).
#pragma once

#include "head_gemm.cuh"

namespace dft {

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
  const size_t plane = (size_t)(gridDim.z >> 1) * lq * lds;
  score_tile<T, true>(reinterpret_cast<T*>(smem),
                         (job ? g : q) + b * as.b + h * as.h, as,
                         (job ? v : k) + b * bs.b + h * bs.h, bs, lq, lk, d,
                         scores + job * plane + (size_t)bh * lq * lds, lds);
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
  const float m = row_max(s4, n4, lk, scale);
  float l = 0.f, edp = 0.f;
  for (int j4 = lane; j4 < n4; j4 += 32) {
    const float4 x = scaled4(s4[j4], j4, lk, scale);
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
    const float4 x = scaled4(s4[j4], j4, lk, scale);
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

// fp32 over few queries (Lq ≤ FEW_QUERIES: the AR cond encoder's 32, the
// prior's and the spec decoder's 16, the attention pool's one) or under
// SHALLOW_K keys: the whole backward in fp64 (head_bwd_f64_*), rounded to
// fp32 once at the output. There dK and dV sum over few queries, so the
// softmax's heavy tail lifts single keys' entries 30-50 times over the
// rms, and the fp32 sums of the scores alone (any order: cuBLAS's fp32
// products too) put them 2-5e-5 of the rms off float64, over the 1e-5
// limit; in fp64 only the output's rounding is left. Its scratch holds S,
// dP, P and dS as fp64 (B·H, Lq, lds) planes.
constexpr int FEW_QUERIES = 32;
constexpr int SHALLOW_K = 8;

__host__ __device__ constexpr bool fp64_backward(int lq, int lk) {
  return lq <= FEW_QUERIES || lk < SHALLOW_K;
}

constexpr int T64 = 32;   // fp64 score tile: T64 keys × T64 queries a block

// grid (ceil(Lk/T64), ceil(Lq/T64), B·H), 256 threads: S = Q Kᵀ and
// dP = g Vᵀ in fp64 into (B·H, Lq, lds) fp64 planes; thread (tj, ti) owns
// key j0 + tj and queries i0 + ti + 8u, u < 4.
__global__ void __launch_bounds__(256) head_bwd_f64_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    double* __restrict__ s, double* __restrict__ dp, int heads, int lq,
    int lk, int d, int lds, Strides qs, Strides ks, Strides vs, Strides gs) {
  __shared__ double tq[T64][T64 + 1], tk[T64][T64 + 1], tg[T64][T64 + 1],
      tv[T64][T64 + 1];
  const int bh = blockIdx.z, b = bh / heads, h = bh - b * heads;
  const int j0 = blockIdx.x * T64, i0 = blockIdx.y * T64;
  const int tj = threadIdx.x & 31, ti = threadIdx.x >> 5;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* gb = g + b * gs.b + h * gs.h;
  double as[4] = {0, 0, 0, 0}, ap[4] = {0, 0, 0, 0};
  for (int d0 = 0; d0 < d; d0 += T64) {
    __syncthreads();
    for (int u = 0; u < 4; ++u) {   // row ti + 8u, column tj of each tile
      const int r = ti + 8 * u, c = d0 + tj;
      const bool ci = c < d, qi = ci && i0 + r < lq, kj = ci && j0 + r < lk;
      tq[r][tj] = qi ? qb[(i0 + r) * qs.l + c * qs.d] : 0.0;
      tg[r][tj] = qi ? gb[(i0 + r) * gs.l + c * gs.d] : 0.0;
      tk[r][tj] = kj ? kb[(j0 + r) * ks.l + c * ks.d] : 0.0;
      tv[r][tj] = kj ? vb[(j0 + r) * vs.l + c * vs.d] : 0.0;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < T64; ++c) {
      const double kc = tk[tj][c], vc = tv[tj][c];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        as[u] = fma(tq[ti + 8 * u][c], kc, as[u]);
        ap[u] = fma(tg[ti + 8 * u][c], vc, ap[u]);
      }
    }
  }
  const int j = j0 + tj;
  if (j >= lk) return;
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ti + 8 * u;
    if (i < lq) {
      const size_t o = ((size_t)bh * lq + i) * lds + j;
      s[o] = as[u];
      dp[o] = ap[u];
    }
  }
}

// One warp per query row, in fp64: m = max(s·scale), e = exp(s·scale − m),
// l = Σ e, δ = Σ e·dP / l; P = e / l and dS = P·(dP − δ) over their own
// planes (padding columns untouched: no product reads them).
__global__ void __launch_bounds__(32 * ROW_WARPS) head_bwd_f64_rows_kernel(
    const double* __restrict__ s, const double* __restrict__ dp,
    double* __restrict__ p, double* __restrict__ ds, int rows, int lk,
    int lds, double scale) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t at = (size_t)row * lds;
  double m = -INFINITY;
  for (int j = lane; j < lk; j += 32) m = fmax(m, s[at + j] * scale);
  for (int o = 16; o > 0; o >>= 1)
    m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  double l = 0.0, edp = 0.0;
  for (int j = lane; j < lk; j += 32) {
    const double e = exp(s[at + j] * scale - m);
    l += e;
    edp += e * dp[at + j];
  }
  for (int o = 16; o > 0; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
    edp += __shfl_xor_sync(0xffffffffu, edp, o);
  }
  const double delta = edp / l;
  for (int j = lane; j < lk; j += 32) {
    const double pj = exp(s[at + j] * scale - m) / l;
    p[at + j] = pj;
    ds[at + j] = pj * (dp[at + j] - delta);
  }
}

// grid (ceil(D/32), ceil(max(Lq, Lk)/8), 3·B·H), 256 threads: product
// z % 3 (0 dQ = dS·K·scale over Lk, 1 dK = dSᵀ·Q·scale and 2 dV = Pᵀ·g over
// Lq) summed in fp64 by thread (column d0 + tx, row r0 + ty), rounded to
// fp32 once into q's, k's or v's strides.
__global__ void __launch_bounds__(256) head_bwd_f64_products_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ g, const double* __restrict__ p,
    const double* __restrict__ ds, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int heads, int lq,
    int lk, int d, int lds, Strides qs, Strides ks, Strides vs, Strides gs,
    float scale) {
  const int bh = blockIdx.z / 3, job = blockIdx.z - 3 * bh;
  const int b = bh / heads, h = bh - b * heads;
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const int r = blockIdx.y * 8 + (threadIdx.x >> 5);
  const int M = job ? lk : lq, K = job ? lq : lk;
  if (r >= M || c >= d) return;
  const size_t at = (size_t)bh * lq * lds;
  // A (r, k): a dS row (dQ) or a dS / P column (dK, dV)
  const double* a = (job == 2 ? p : ds) + at + (job ? r : (size_t)r * lds);
  const long long ak = job ? lds : 1;
  const Strides bs = job == 0 ? ks : (job == 1 ? qs : gs);
  const float* bp = (job == 0 ? k : (job == 1 ? q : g)) + b * bs.b +
                    h * bs.h + c * bs.d;
  double acc = 0.0;
  for (int kk = 0; kk < K; ++kk)
    acc = fma(a[kk * ak], (double)bp[kk * bs.l], acc);
  const Strides os = job == 0 ? qs : (job == 1 ? ks : vs);
  float* out = (job == 0 ? dq : (job == 1 ? dk : dv)) + b * os.b + h * os.h;
  out[r * os.l + c * os.d] = (float)(job == 2 ? acc : acc * (double)scale);
}

static cudaError_t launch_head_bwd64(const void* q, const void* k,
                                     const void* v, const void* g, void* dq,
                                     void* dk, void* dv, void* scratch, int b,
                                     int h, int lq, int lk, int d,
                                     const Strides* st, float scale,
                                     cudaStream_t stream) {
  const int bh = b * h, lds = scratch_ld(lk);
  const size_t plane = (size_t)bh * lq * lds;
  double* s = (double*)scratch;
  double *dp = s + plane, *p = dp + plane, *ds = p + plane;
  dim3 g1((lk + T64 - 1) / T64, (lq + T64 - 1) / T64, bh);
  head_bwd_f64_scores_kernel<<<g1, 256, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, s,
      dp, h, lq, lk, d, lds, st[0], st[1], st[2], st[3]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = bh * lq;
  head_bwd_f64_rows_kernel<<<(rows + ROW_WARPS - 1) / ROW_WARPS,
                           32 * ROW_WARPS, 0, stream>>>(s, dp, p, ds, rows,
                                                        lk, lds, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int lmax = lq > lk ? lq : lk;
  dim3 g3((d + 31) / 32, (lmax + 7) / 8, 3 * bh);
  head_bwd_f64_products_kernel<<<g3, 256, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)g, p, ds, (float*)dq,
      (float*)dk, (float*)dv, h, lq, lk, d, lds, st[0], st[1], st[2], st[3],
      scale);
  return cudaGetLastError();
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
  gemm_any<T, true>(reinterpret_cast<T*>(smem), a, asr, ask, M, bp, bs.d,
                    bs.l, d, K, m0, n0, acc);
  const Strides os = job == 0 ? qs : (job == 1 ? ks : vs);
  T* out = (job == 0 ? dq : (job == 1 ? dk : dv)) + b * os.b + h * os.h;
  const float mult = job == 2 ? 1.f : scale;
  for_tile(acc, m0, n0, M, d, [&](int r, int c, float x) {
    out[r * os.l + c * os.d] = from_f<T>(x * mult);
  });
}

template <typename T>
static cudaError_t launch_head_bwd(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, void* scratch, int b,
                                   int h, int lq, int lk, int d,
                                   const Strides* st, float scale,
                                   cudaStream_t stream) {
  if (sizeof(T) == 4 && fp64_backward(lq, lk))
    return launch_head_bwd64(q, k, v, g, dq, dk, dv, scratch, b, h, lq, lk,
                             d, st, scale, stream);
  const int bh = b * h, lds = scratch_ld(lk);
  const size_t plane = (size_t)bh * lq * lds;
  float* scores = (float*)scratch;  // S, then dP
  T* pt = (T*)(scores + 2 * plane);
  T* ds = pt + plane;
  constexpr int smem = GemmTile<T>::SMEM;
  auto products = head_bwd_products_kernel<T>;
  static SmemLimit limit_s, limit_p;
  cudaError_t err = limit_s.raise(head_bwd_scores_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = limit_p.raise(products, smem);
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
  products<<<g3, GNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)g, pt, ds, (T*)dq, (T*)dk, (T*)dv,
      h, lq, lk, d, lds, st[0], st[1], st[2], st[3], scale);
  return cudaGetLastError();
}

// The whole backward for one dtype code: 1 (cudaErrorInvalidValue) for
// shapes or strides it does not take (each operand with stride 1 along its
// rows or its columns), else the cudaError_t of the launches. The fp32
// products take gemm_tile's precise accumulation; an fp32 call over few
// queries or keys (fp64_backward) runs in fp64.
static int head_bwd(const void* q, const void* k, const void* v,
                    const void* g, void* dq, void* dk, void* dv,
                    void* scratch, int b, int h, int lq, int lk, int d,
                    const Strides* st, float scale, int dtype,
                    void* stream) {
  if (b < 1 || h < 1 || lq < 1 || lk < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (st[i].l != 1 && st[i].d != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return (int)launch_head_bwd<float>(q, k, v, g, dq, dk, dv, scratch, b,
                                       h, lq, lk, d, st, scale, s);
  if (dtype == DTYPE_BF16)
    return (int)launch_head_bwd<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, scratch, b, h, lq, lk, d, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dft
