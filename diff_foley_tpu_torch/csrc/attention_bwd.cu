// Packed-heads softmax attention backward for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_packed_bwd_kernel
// (launched by _pallas_backward_packed, vjp _packed_bwd). Given the saved
// q, k, v (B, L, H·D) and the output gradient g:
//   P  = softmax(Q Kᵀ · scale)                       (recomputed, fp32)
//   dV = P̃ᵀ g            with P̃ = P cast to g's type
//   dS = P ∘ (g Vᵀ − Σ_j (g Vᵀ ∘ P))  cast to q's type
//   dQ = dS K · scale,   dK = dSᵀ Q · scale
// with fp32 accumulation; dQ, dK and dV are returned in the operand type.
//
// The TPU kernel walks query chunks in order and carries dK/dV in output
// blocks it revisits. Blocks on this card run in no order, so the work is
// split in two launches:
//   1. attn_packed_bwd_dq_kernel, one block per query tile: row max and
//      sum, then δ_i = Σ_j P_ij (g Vᵀ)_ij, then dQ. It stores (m, l, δ)
//      per row for launch 2.
//   2. attn_packed_bwd_dkdv_kernel, one block per key tile: loops over all
//      query tiles and accumulates dK and dV in registers, in fp32.
// Bound on this card: 10·B·H·Lq·Lk·D operations (five products) against
// (3·Lq + 4·Lk)·B·H·D operand elements read and written; in bf16 at the
// path's classifier shapes (L ≤ 256, D = 32) that is byte-bound. This first
// kernel uses fp32 FMAs from shared memory and recomputes Q Kᵀ and g Vᵀ
// in several passes; it is correct and simple, not fast.
#include "attention_common.cuh"

namespace dft {

// grid (ceil(Lq/BQ), H, B), NT threads. stats: 3 × (B, H, Lq) fp32.
template <typename T, int NC>
__global__ void __launch_bounds__(NT) attn_packed_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ stats,
    int batch, int lq, int lk, int heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(d);
  float* Qs = smem;
  float* Gs = Qs + BQ * ld;
  float* Ks = Gs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ds = Vs + BK * ld;  // (BQ, SLD)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * d;
  const int col0 = h * d;
  const T* qb = q + (size_t)b * lq * hd;
  const T* gb = g + (size_t)b * lq * hd;
  const T* kb = k + (size_t)b * lk * hd;
  const T* vb = v + (size_t)b * lk * hd;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T>(Qs, ld, qb, q0, BQ, lq, hd, col0, d);
  load_tile<T>(Gs, ld, gb, q0, BQ, lq, hd, col0, d);
  float m[4], l[4];
  row_stats<T>(Qs, Ks, kb, lk, hd, col0, d, scale, m, l);

  // δ_i = Σ_j P_ij · (g Vᵀ)_ij
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();
    load_tile<T>(Ks, ld, kb, k0, BK, lk, hd, col0, d);
    load_tile<T>(Vs, ld, vb, k0, BK, lk, hd, col0, d);
    __syncthreads();
    float s[4][4], gp[4][4];
    tile_abt(Qs, Ks, ld, d, s);
    tile_abt(Gs, Vs, ld, d, gp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        if (k0 + tx + 16 * bb < lk)
          delta[a] += gp[a][bb] * (expf(s[a][bb] * scale - m[a]) / l[a]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) delta[a] = row16_sum(delta[a]);

  float acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = 0.f;
  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();
    load_tile<T>(Ks, ld, kb, k0, BK, lk, hd, col0, d);
    load_tile<T>(Vs, ld, vb, k0, BK, lk, hd, col0, d);
    __syncthreads();
    float s[4][4], gp[4][4];
    tile_abt(Qs, Ks, ld, d, s);
    tile_abt(Gs, Vs, ld, d, gp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = tx + 16 * bb;
        float ds = 0.f;
        if (k0 + j < lk) {
          const float p = expf(s[a][bb] * scale - m[a]) / l[a];
          ds = p * (gp[a][bb] - delta[a]);
        }
        Ds[(ty + 16 * a) * SLD + j] = round_as<T>(ds);
      }
    __syncthreads();
    const int n = lk - k0 < BK ? lk - k0 : BK;
    acc_pv<NC>(Ds, false, Ks, ld, d, n, acc);
  }

  const int r = threadIdx.x >> 2;
  const int cg = threadIdx.x & 3;
  if (q0 + r < lq) {
    T* row = dq + ((size_t)b * lq + q0 + r) * hd + col0;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = cg + 4 * u;
      if (c < d) row[c] = from_f<T>(acc[u] * scale);
    }
  }
  if (tx == 0) {
    const size_t plane = (size_t)batch * heads * lq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      if (i < lq) {
        const size_t at = ((size_t)b * heads + h) * lq + i;
        stats[at] = m[a];
        stats[plane + at] = l[a];
        stats[2 * plane + at] = delta[a];
      }
    }
  }
}

// grid (ceil(Lk/BK), H, B), NT threads
template <typename T, int NC>
__global__ void __launch_bounds__(NT) attn_packed_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ stats,
    T* __restrict__ dk, T* __restrict__ dv, int batch, int lq, int lk,
    int heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(d);
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* Gs = Qs + BQ * ld;
  float* Ps = Gs + BQ * ld;   // (BQ, SLD): P cast to g's type
  float* Ds = Ps + BQ * SLD;  // (BQ, SLD): dS cast to q's type
  float* Ms = Ds + BQ * SLD;  // (3, BQ): m, l, δ of the query tile

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * d;
  const int col0 = h * d;
  const T* qb = q + (size_t)b * lq * hd;
  const T* gb = g + (size_t)b * lq * hd;
  const T* kb = k + (size_t)b * lk * hd;
  const T* vb = v + (size_t)b * lk * hd;
  const size_t plane = (size_t)batch * heads * lq;
  const float* st = stats + ((size_t)b * heads + h) * lq;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T>(Ks, ld, kb, k0, BK, lk, hd, col0, d);
  load_tile<T>(Vs, ld, vb, k0, BK, lk, hd, col0, d);

  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc_k[u] = acc_v[u] = 0.f;

  for (int q0 = 0; q0 < lq; q0 += BQ) {
    __syncthreads();
    load_tile<T>(Qs, ld, qb, q0, BQ, lq, hd, col0, d);
    load_tile<T>(Gs, ld, gb, q0, BQ, lq, hd, col0, d);
    if (threadIdx.x < BQ) {
      const int i = q0 + threadIdx.x;
      const bool ok = i < lq;
      Ms[threadIdx.x] = ok ? st[i] : 0.f;
      Ms[BQ + threadIdx.x] = ok ? st[plane + i] : 1.f;
      Ms[2 * BQ + threadIdx.x] = ok ? st[2 * plane + i] : 0.f;
    }
    __syncthreads();
    float s[4][4], gp[4][4];
    tile_abt(Qs, Ks, ld, d, s);   // rows: queries, columns: keys
    tile_abt(Gs, Vs, ld, d, gp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = tx + 16 * bb;
        float p = 0.f, ds = 0.f;
        if (q0 + i < lq && k0 + j < lk) {
          p = expf(s[a][bb] * scale - Ms[i]) / Ms[BQ + i];
          ds = p * (gp[a][bb] - Ms[2 * BQ + i]);
        }
        Ps[i * SLD + j] = round_as<T>(p);
        Ds[i * SLD + j] = round_as<T>(ds);
      }
    }
    __syncthreads();
    const int n = lq - q0 < BQ ? lq - q0 : BQ;
    acc_pv<NC>(Ps, true, Gs, ld, d, n, acc_v);  // dV_j += Σ_i P̃_ij g_i
    acc_pv<NC>(Ds, true, Qs, ld, d, n, acc_k);  // dK_j += Σ_i dS_ij Q_i
  }

  const int r = threadIdx.x >> 2;
  const int cg = threadIdx.x & 3;
  if (k0 + r < lk) {
    const size_t at = ((size_t)b * lk + k0 + r) * hd + col0;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = cg + 4 * u;
      if (c < d) {
        dk[at + c] = from_f<T>(acc_k[u] * scale);
        dv[at + c] = from_f<T>(acc_v[u]);
      }
    }
  }
}

template <typename T, int NC>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                              const void* g, void* dq, void* dk, void* dv,
                              float* stats, int b, int lq, int lk, int heads,
                              int d, float scale, cudaStream_t stream) {
  const int ld = tile_ld(d);
  const size_t smem_dq =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * ld + BQ * SLD);
  const size_t smem_kv =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * ld + 2 * BQ * SLD + 3 * BQ);
  auto kdq = attn_packed_bwd_dq_kernel<T, NC>;
  auto kkv = attn_packed_bwd_dkdv_kernel<T, NC>;
  // d = 4·NC, so both budgets are fixed per instantiation
  static SmemLimit limit_dq, limit_kv;
  cudaError_t err = limit_dq.raise(kdq, smem_dq);
  if (err != cudaSuccess) return err;
  err = limit_kv.raise(kkv, smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_q((lq + BQ - 1) / BQ, heads, b);
  kdq<<<grid_q, NT, smem_dq, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                       (const T*)g, (T*)dq, stats, b, lq, lk,
                                       heads, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((lk + BK - 1) / BK, heads, b);
  kkv<<<grid_k, NT, smem_kv, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                       (const T*)g, (const float*)stats,
                                       (T*)dk, (T*)dv, b, lq, lk, heads, d,
                                       scale);
  return cudaGetLastError();
}

}  // namespace dft

// q and g (b, lq, heads·d), k and v (b, lk, heads·d); dq, dk, dv shaped as
// q, k, v; stats a scratch of 3·b·heads·lq fp32. All contiguous, operands
// of one dtype (DTYPE_F32 or DTYPE_BF16). Returns the cudaError_t of the
// launches; 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int dft_attn_packed_bwd(const void* q, const void* k, const void* v,
                                   const void* g, void* dq, void* dk, void* dv,
                                   void* stats, int b, int lq, int lk,
                                   int heads, int d, float scale, int dtype,
                                   void* stream) {
  if (b < 1 || lq < 1 || lk < 1 || heads < 1 || !dft::supported_head_dim(d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == dft::DTYPE_F32) {
    DFT_DISPATCH_NC(d, err = dft::launch_bwd<float, NC>(
                           q, k, v, g, dq, dk, dv, st, b, lq, lk, heads, d,
                           scale, s));
  } else if (dtype == dft::DTYPE_BF16) {
    DFT_DISPATCH_NC(d, err = dft::launch_bwd<__nv_bfloat16, NC>(
                           q, k, v, g, dq, dk, dv, st, b, lq, lk, heads, d,
                           scale, s));
  }
  return (int)err;
}
