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
// The TPU kernel walks query chunks in order and carries dK/dV in output
// blocks it revisits. Blocks on this card run in no order, so the work is
// split in two launches, as the packed backward (attention_bwd.cu):
//   1. attn_head_bwd_dq_kernel, one block per 32-query tile: row max and
//      sum, then δ_i = Σ_j P_ij (g Vᵀ)_ij, then dQ. It stores (m, l, δ)
//      per row for launch 2.
//   2. attn_head_bwd_dkdv_kernel, one block per 16-key tile: loops over all
//      query tiles and accumulates dK and dV in registers, in fp32. No
//      atomics; the result does not depend on the order of the blocks.
//
// D 512 sets the tiles. Both launches need Q, g, K and V tiles at once:
// four 32-row fp32 tiles would take 264 KB. Key tiles have 16 rows
// instead: 32 rows of Q and g, 16 of K and V, 198 KB, one block per SM.
// The 256 threads split dQ as 32 rows × 8 float4 column groups (D/8 fp32
// accumulators each, as the forward) and dK and dV as 16 rows × 16 groups
// (D/16 each for dK and for dV): 64 accumulators a thread at D 512 in
// either launch.
//
// q, k, v and g each come with their own strides (the VAE's are NCHW maps
// seen as tokens; the gradient has whatever layout autograd hands over);
// dQ, dK and dV are written in q's, k's and v's strides.
//
// Bound on this card: 10·B·H·Lq·Lk·D operations (five products) against
// (3·Lq + 4·Lk)·B·H·D operand elements: operation-bound at L 1024, D 512.
// This first kernel uses fp32 FMAs from shared memory and recomputes Q Kᵀ
// and g Vᵀ in several passes (ten tile products where five are needed);
// it is correct and simple, not fast.
#include "attention_head_common.cuh"

namespace dft {

constexpr int BK2 = 16;        // key rows per tile
constexpr int PLD = BK2 + 1;   // leading dimension of (HQ, BK2) score tiles

struct Strides {
  long long b, h, l, d;
};

template <int D>
constexpr size_t head_bwd_tiles() {
  return (size_t)(2 * HQ + 2 * BK2) * HeadTile<D>::LD;
}

// s = A Bᵀ for the thread's two query rows (ty, ty + 16) and key tx
template <int D>
__device__ __forceinline__ void scores2(const float* As, const float* Bs,
                                        float s[2]) {
  float t[2][1];
  head_scores<D, 1>(As, Bs, t);
  s[0] = t[0][0];
  s[1] = t[1][0];
}

// grid (ceil(Lq / HQ), H, B), HNT threads. stats: 3 × (B, H, Lq) fp32.
template <typename T, int D>
__global__ void __launch_bounds__(HNT) attn_head_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ stats,
    int lq, int lk, Strides qs, Strides ks, Strides vs, Strides gs,
    float scale) {
  constexpr int LD = HeadTile<D>::LD;
  constexpr int NC = D / 32;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + HQ * LD;
  float* Ks = Gs + HQ * LD;
  float* Vs = Ks + BK2 * LD;
  float* Ds = Vs + BK2 * LD;  // (HQ, PLD)

  const int q0 = blockIdx.x * HQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* gb = g + b * gs.b + h * gs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, LD, qb + q0 * qs.l, qs.l, qs.d, 0, HQ, lq - q0);
  load_rows<T, D>(Gs, LD, gb + q0 * gs.l, gs.l, gs.d, 0, HQ, lq - q0);

  // pass 1: each row's max m and sum l of exp(s·scale − m)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < lk; k0 += BK2) {
    __syncthreads();
    load_rows<T, D>(Ks, LD, kb, ks.l, ks.d, k0, BK2, lk);
    __syncthreads();
    float s[2];
    scores2<D>(Qs, Ks, s);
    const bool ok = k0 + tx < lk;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float mn =
          fmaxf(m[a], half_warp_max(ok ? s[a] * scale : -INFINITY));
      const float e = ok ? expf(s[a] * scale - mn) : 0.f;
      l[a] = l[a] * expf(m[a] - mn) + half_warp_sum(e);
      m[a] = mn;
    }
  }

  // pass 2: δ_i = Σ_j P_ij · (g Vᵀ)_ij
  float delta[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < lk; k0 += BK2) {
    __syncthreads();
    load_rows<T, D>(Ks, LD, kb, ks.l, ks.d, k0, BK2, lk);
    load_rows<T, D>(Vs, LD, vb, vs.l, vs.d, k0, BK2, lk);
    __syncthreads();
    float s[2], gp[2];
    scores2<D>(Qs, Ks, s);
    scores2<D>(Gs, Vs, gp);
    if (k0 + tx < lk) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
        delta[a] += gp[a] * (expf(s[a] * scale - m[a]) / l[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) delta[a] = half_warp_sum(delta[a]);

  // pass 3: dS rounded to T, accumulated into dS·K. Thread t owns row
  // r = t / 8 and the float4 column groups cg + 8u (u < NC), cg = t % 8.
  const int r = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  float4 acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < lk; k0 += BK2) {
    __syncthreads();
    load_rows<T, D>(Ks, LD, kb, ks.l, ks.d, k0, BK2, lk);
    load_rows<T, D>(Vs, LD, vb, vs.l, vs.d, k0, BK2, lk);
    __syncthreads();
    float s[2], gp[2];
    scores2<D>(Qs, Ks, s);
    scores2<D>(Gs, Vs, gp);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float ds = 0.f;
      if (k0 + tx < lk) {
        const float p = expf(s[a] * scale - m[a]) / l[a];
        ds = p * (gp[a] - delta[a]);
      }
      Ds[(ty + 16 * a) * PLD + tx] = round_as<T>(ds);
    }
    __syncthreads();
    const int n = lk - k0 < BK2 ? lk - k0 : BK2;
    for (int j = 0; j < n; ++j) {
      const float ds = Ds[r * PLD + j];
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * LD);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const float4 w = kr[cg + 8 * u];
        acc[u].x = fmaf(ds, w.x, acc[u].x);
        acc[u].y = fmaf(ds, w.y, acc[u].y);
        acc[u].z = fmaf(ds, w.z, acc[u].z);
        acc[u].w = fmaf(ds, w.w, acc[u].w);
      }
    }
  }

  if (tx == 0) {
    const size_t plane = (size_t)gridDim.z * gridDim.y * lq;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = q0 + ty + 16 * a;
      if (i < lq) {
        const size_t at = ((size_t)b * gridDim.y + h) * lq + i;
        stats[at] = m[a];
        stats[plane + at] = l[a];
        stats[2 * plane + at] = delta[a];
      }
    }
  }

  // stage the (HQ, D) dQ through the g tile, then store it in q's strides
  // with the stride-1 axis on consecutive threads
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    float4 w = acc[u];
    w.x *= scale, w.y *= scale, w.z *= scale, w.w *= scale;
    *reinterpret_cast<float4*>(Gs + r * LD + 4 * (cg + 8 * u)) = w;
  }
  __syncthreads();
  const int rows = lq - q0 < HQ ? lq - q0 : HQ;
  store_rows<T, D>(dq + b * qs.b + h * qs.h + q0 * qs.l, qs.l, qs.d, Gs, LD,
                   rows);
}

// grid (ceil(Lk / BK2), H, B), HNT threads
template <typename T, int D>
__global__ void __launch_bounds__(HNT) attn_head_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ stats,
    T* __restrict__ dk, T* __restrict__ dv, int lq, int lk, Strides qs,
    Strides ks, Strides vs, Strides gs, float scale) {
  constexpr int LD = HeadTile<D>::LD;
  constexpr int G4 = D / 4;            // float4 groups in a row
  constexpr int NC = (G4 + 15) / 16;   // of them per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + HQ * LD;
  float* Ks = Gs + HQ * LD;
  float* Vs = Ks + BK2 * LD;
  float* Ps = Vs + BK2 * LD;  // (HQ, PLD): P cast to g's type
  float* Ds = Ps + HQ * PLD;  // (HQ, PLD): dS cast to q's type
  float* Ms = Ds + HQ * PLD;  // (3, HQ): m, l, δ of the query tile

  const int k0 = blockIdx.x * BK2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* gb = g + b * gs.b + h * gs.h;
  const size_t plane = (size_t)gridDim.z * gridDim.y * lq;
  const float* st = stats + ((size_t)b * gridDim.y + h) * lq;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows<T, D>(Ks, LD, k + b * ks.b + h * ks.h, ks.l, ks.d, k0, BK2, lk);
  load_rows<T, D>(Vs, LD, v + b * vs.b + h * vs.h, vs.l, vs.d, k0, BK2, lk);

  // thread t owns key row r = t / 16 and the float4 column groups
  // cg + 16u (u < NC) that lie inside the row, cg = t % 16
  const int r = ty;
  const int cg = tx;
  float4 acc_k[NC], acc_v[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u)
    acc_k[u] = acc_v[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int q0 = 0; q0 < lq; q0 += HQ) {
    __syncthreads();
    load_rows<T, D>(Qs, LD, qb, qs.l, qs.d, q0, HQ, lq);
    load_rows<T, D>(Gs, LD, gb, gs.l, gs.d, q0, HQ, lq);
    if (threadIdx.x < HQ) {
      const int i = q0 + threadIdx.x;
      const bool ok = i < lq;
      Ms[threadIdx.x] = ok ? st[i] : 0.f;
      Ms[HQ + threadIdx.x] = ok ? st[plane + i] : 1.f;
      Ms[2 * HQ + threadIdx.x] = ok ? st[2 * plane + i] : 0.f;
    }
    __syncthreads();
    float s[2], gp[2];
    scores2<D>(Qs, Ks, s);   // rows: queries, column: key tx
    scores2<D>(Gs, Vs, gp);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = ty + 16 * a;
      float p = 0.f, ds = 0.f;
      if (q0 + i < lq && k0 + tx < lk) {
        p = expf(s[a] * scale - Ms[i]) / Ms[HQ + i];
        ds = p * (gp[a] - Ms[2 * HQ + i]);
      }
      Ps[i * PLD + tx] = round_as<T>(p);
      Ds[i * PLD + tx] = round_as<T>(ds);
    }
    __syncthreads();
    const int n = lq - q0 < HQ ? lq - q0 : HQ;
    for (int i = 0; i < n; ++i) {
      const float p = Ps[i * PLD + r];    // dV_j += Σ_i P̃_ij g_i
      const float ds = Ds[i * PLD + r];   // dK_j += Σ_i dS_ij Q_i
      const float4* gr = reinterpret_cast<const float4*>(Gs + i * LD);
      const float4* qr = reinterpret_cast<const float4*>(Qs + i * LD);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        if (cg + 16 * u < G4) {
          const float4 wg = gr[cg + 16 * u];
          const float4 wq = qr[cg + 16 * u];
          acc_v[u].x = fmaf(p, wg.x, acc_v[u].x);
          acc_v[u].y = fmaf(p, wg.y, acc_v[u].y);
          acc_v[u].z = fmaf(p, wg.z, acc_v[u].z);
          acc_v[u].w = fmaf(p, wg.w, acc_v[u].w);
          acc_k[u].x = fmaf(ds, wq.x, acc_k[u].x);
          acc_k[u].y = fmaf(ds, wq.y, acc_k[u].y);
          acc_k[u].z = fmaf(ds, wq.z, acc_k[u].z);
          acc_k[u].w = fmaf(ds, wq.w, acc_k[u].w);
        }
      }
    }
  }

  // stage dK through the Q tile and dV through the g tile, then store them
  // in k's and v's strides
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    if (cg + 16 * u < G4) {
      float4 w = acc_k[u];
      w.x *= scale, w.y *= scale, w.z *= scale, w.w *= scale;
      *reinterpret_cast<float4*>(Qs + r * LD + 4 * (cg + 16 * u)) = w;
      *reinterpret_cast<float4*>(Gs + r * LD + 4 * (cg + 16 * u)) = acc_v[u];
    }
  }
  __syncthreads();
  const int rows = lk - k0 < BK2 ? lk - k0 : BK2;
  store_rows<T, D>(dk + b * ks.b + h * ks.h + k0 * ks.l, ks.l, ks.d, Qs, LD,
                   rows);
  store_rows<T, D>(dv + b * vs.b + h * vs.h + k0 * vs.l, vs.l, vs.d, Gs, LD,
                   rows);
}

template <typename T, int D>
static cudaError_t launch_head_bwd(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, float* stats, int b,
                                   int h, int lq, int lk, const Strides* st,
                                   float scale, cudaStream_t stream) {
  const size_t smem_dq =
      sizeof(float) * (head_bwd_tiles<D>() + (size_t)HQ * PLD);
  const size_t smem_kv =
      sizeof(float) * (head_bwd_tiles<D>() + (size_t)2 * HQ * PLD + 3 * HQ);
  auto kdq = attn_head_bwd_dq_kernel<T, D>;
  auto kkv = attn_head_bwd_dkdv_kernel<T, D>;
  static SmemLimit limit_dq, limit_kv;
  cudaError_t err = limit_dq.raise(kdq, smem_dq);
  if (err != cudaSuccess) return err;
  err = limit_kv.raise(kkv, smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_q((lq + HQ - 1) / HQ, h, b);
  kdq<<<grid_q, HNT, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (T*)dq, stats, lq,
      lk, st[0], st[1], st[2], st[3], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((lk + BK2 - 1) / BK2, h, b);
  kkv<<<grid_k, HNT, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g,
      (const float*)stats, (T*)dk, (T*)dv, lq, lk, st[0], st[1], st[2], st[3],
      scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_head_bwd(const void* q, const void* k,
                                     const void* v, const void* g, void* dq,
                                     void* dk, void* dv, float* stats, int b,
                                     int h, int lq, int lk, int d,
                                     const Strides* st, float scale,
                                     cudaStream_t stream) {
  // the path's head dims: 512 in the SD VAE's mid attention, 32 in the
  // tiny agreement VAE (ch 32)
  if (d == 512)
    return launch_head_bwd<T, 512>(q, k, v, g, dq, dk, dv, stats, b, h, lq,
                                   lk, st, scale, stream);
  if (d == 32)
    return launch_head_bwd<T, 32>(q, k, v, g, dq, dk, dv, stats, b, h, lq, lk,
                                  st, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dft

// q and g (b, h, lq, d), k and v (b, h, lk, d), each with its own strides
// in elements (batch, head, row, column): strides[0:4] q's (and dq's),
// [4:8] k's (and dk's), [8:12] v's (and dv's), [12:16] g's. stats is a
// scratch of 3·b·h·lq fp32. Operands of one dtype (DTYPE_F32 or
// DTYPE_BF16). Returns the cudaError_t of the launches; 1
// (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int dft_attn_bwd(const void* q, const void* k, const void* v,
                            const void* g, void* dq, void* dk, void* dv,
                            void* stats, int b, int h, int lq, int lk, int d,
                            long long qsb, long long qsh, long long qsl,
                            long long qsd, long long ksb, long long ksh,
                            long long ksl, long long ksd, long long vsb,
                            long long vsh, long long vsl, long long vsd,
                            long long gsb, long long gsh, long long gsl,
                            long long gsd, float scale, int dtype,
                            void* stream) {
  if (b < 1 || h < 1 || lq < 1 || lk < 1) return (int)cudaErrorInvalidValue;
  const dft::Strides st[4] = {{qsb, qsh, qsl, qsd},
                              {ksb, ksh, ksl, ksd},
                              {vsb, vsh, vsl, vsd},
                              {gsb, gsh, gsl, gsd}};
  cudaStream_t s = (cudaStream_t)stream;
  float* sp = (float*)stats;
  if (dtype == dft::DTYPE_F32)
    return (int)dft::dispatch_head_bwd<float>(q, k, v, g, dq, dk, dv, sp, b,
                                              h, lq, lk, d, st, scale, s);
  if (dtype == dft::DTYPE_BF16)
    return (int)dft::dispatch_head_bwd<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, sp, b, h, lq, lk, d, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
