// Per-head softmax attention forward over (B, H, L, D) for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_kernel (launched
// by _pallas_forward, entry flash_attention):
//   O[b, h] = softmax(Q[b, h] K[b, h]ᵀ · scale) V[b, h]
// no mask. The path runs it in the VAE's single-head mid attention
// (B, 1, 1024, 512), encoder and decoder; the tiny agreement VAE at D 32.
//
// Numerics are kernel 1's (attention_fwd.cu): fp32 scores times scale, row
// max, P = e / Σe in fp32, P rounded to V's type, fp32 P·V, output rounded.
// Normalising before the cast takes two passes over the keys: row max and
// sum first, then P and P·V.
//
// D 512 is what sets the design. A 64-row fp32 tile of Q or K is 129 KB
// there, and a thread owning D/4 output columns would need 128
// accumulators. So a block owns 32 query rows (BQ), streams 32-key tiles
// (BK), and its 256 threads split the output as 32 rows × 8 column groups:
// D/8 fp32 accumulators each (64 at D 512). Q, K and V tiles (fp32) and the
// (BQ, BK) P tile take 197 KB of shared memory at D 512: one block per SM.
// Tile staging, strides and the score product are attention_head_common.cuh's,
// shared with the backward (attention_head_bwd.cu).
//
// Bound on this card: 4·B·H·Lq·Lk·D operations against (2·Lq + 2·Lk)·B·H·D
// operand elements: at L 1024, D 512 in bf16, 8.6 GFLOP over 8 MB for
// B 4, operation-bound on the tensor cores (~10 µs) and far from that
// with fp32 FMAs from shared memory, which this first kernel uses. Tensor
// cores (mma/wgmma) and a single online pass are later work.
#include "attention_head_common.cuh"

namespace dft {

constexpr int HK = 32;         // key rows per tile
constexpr int HSLD = HK + 1;   // leading dimension of the P tile

// Q and K tiles (leading dimension D + 4), the V tile and the P tile
template <int D>
constexpr size_t head_fwd_smem_bytes() {
  return sizeof(float) * ((size_t)(HQ + HK) * HeadTile<D>::LD +
                          (size_t)HK * D + (size_t)HQ * HSLD);
}

// grid (ceil(Lq / HQ), H, B), HNT threads. q and o share strides (qs*),
// k and v share theirs (ks*): batch, head, row, column.
template <typename T, int D>
__global__ void __launch_bounds__(HNT)
    attn_head_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int lq,
                         int lk, long long qsb, long long qsh, long long qsl,
                         long long qsd, long long ksb, long long ksh,
                         long long ksl, long long ksd, float scale) {
  constexpr int LD = HeadTile<D>::LD;
  constexpr int NC = D / 32;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + HQ * LD;
  float* Vs = Ks + HK * LD;   // (HK, D)
  float* Ps = Vs + HK * D;    // (HQ, HSLD)

  const int q0 = blockIdx.x * HQ;
  const T* qb = q + blockIdx.z * qsb + blockIdx.y * qsh;
  const T* kb = k + blockIdx.z * ksb + blockIdx.y * ksh;
  const T* vb = v + blockIdx.z * ksb + blockIdx.y * ksh;
  T* ob = o + blockIdx.z * qsb + blockIdx.y * qsh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, LD, qb + q0 * qsl, qsl, qsd, 0, HQ, lq - q0);

  // pass 1: each row's max m and sum l of exp(s·scale − m)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < lk; k0 += HK) {
    __syncthreads();
    load_rows<T, D>(Ks, LD, kb, ksl, ksd, k0, HK, lk);
    __syncthreads();
    float s[2][2];
    head_scores<D, 2>(Qs, Ks, s);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (k0 + tx + 16 * b < lk) mx = fmaxf(mx, s[a][b] * scale);
      const float mn = fmaxf(m[a], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (k0 + tx + 16 * b < lk) sum += expf(s[a][b] * scale - mn);
      l[a] = l[a] * expf(m[a] - mn) + half_warp_sum(sum);
      m[a] = mn;
    }
  }

  // pass 2: P normalised in fp32, rounded to T, accumulated into P·V.
  // Thread t owns row r = t / 8 and the float4 column groups
  // cg + 8u (u < NC), cg = t % 8.
  const int r = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  float4 acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < lk; k0 += HK) {
    __syncthreads();
    load_rows<T, D>(Ks, LD, kb, ksl, ksd, k0, HK, lk);
    load_rows<T, D>(Vs, D, vb, ksl, ksd, k0, HK, lk);
    __syncthreads();
    float s[2][2];
    head_scores<D, 2>(Qs, Ks, s);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int j = tx + 16 * b;
        const float p =
            k0 + j < lk ? expf(s[a][b] * scale - m[a]) / l[a] : 0.f;
        Ps[(ty + 16 * a) * HSLD + j] = round_as<T>(p);
      }
    __syncthreads();
    const int n = lk - k0 < HK ? lk - k0 : HK;
    for (int j = 0; j < n; ++j) {
      const float p = Ps[r * HSLD + j];
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * D);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const float4 w = vr[cg + 8 * u];
        acc[u].x = fmaf(p, w.x, acc[u].x);
        acc[u].y = fmaf(p, w.y, acc[u].y);
        acc[u].z = fmaf(p, w.z, acc[u].z);
        acc[u].w = fmaf(p, w.w, acc[u].w);
      }
    }
  }

  // stage the (HQ, D) output through the Q tile, then store it with the
  // stride-1 axis on consecutive threads
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NC; ++u)
    *reinterpret_cast<float4*>(Qs + r * LD + 4 * (cg + 8 * u)) = acc[u];
  __syncthreads();
  const int rows = lq - q0 < HQ ? lq - q0 : HQ;
  store_rows<T, D>(ob + q0 * qsl, qsl, qsd, Qs, LD, rows);
}

template <typename T, int D>
static cudaError_t launch_head_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int h,
                                   int lq, int lk, const long long* qs,
                                   const long long* ks, float scale,
                                   cudaStream_t stream) {
  const size_t smem = head_fwd_smem_bytes<D>();
  auto kernel = attn_head_fwd_kernel<T, D>;
  static SmemLimit limit;
  cudaError_t err = limit.raise(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + HQ - 1) / HQ, h, b);
  kernel<<<grid, HNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lq, lk, qs[0], qs[1],
      qs[2], qs[3], ks[0], ks[1], ks[2], ks[3], scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_head_fwd(const void* q, const void* k,
                                     const void* v, void* o, int b, int h,
                                     int lq, int lk, int d, const long long* qs,
                                     const long long* ks, float scale,
                                     cudaStream_t stream) {
  // the path's head dims: 512 in the SD VAE's mid attention, 32 in the
  // tiny agreement VAE (ch 32)
  if (d == 512)
    return launch_head_fwd<T, 512>(q, k, v, o, b, h, lq, lk, qs, ks, scale,
                                   stream);
  if (d == 32)
    return launch_head_fwd<T, 32>(q, k, v, o, b, h, lq, lk, qs, ks, scale,
                                  stream);
  return cudaErrorInvalidValue;
}

}  // namespace dft

// q and o (b, h, lq, d) with strides qsb, qsh, qsl, qsd (elements); k and v
// (b, h, lk, d) with strides ksb, ksh, ksl, ksd; one dtype (DTYPE_F32 or
// DTYPE_BF16). Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int dft_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, int b, int h, int lq, int lk, int d,
                            long long qsb, long long qsh, long long qsl,
                            long long qsd, long long ksb, long long ksh,
                            long long ksl, long long ksd, float scale,
                            int dtype, void* stream) {
  if (b < 1 || h < 1 || lq < 1 || lk < 1) return (int)cudaErrorInvalidValue;
  const long long qs[4] = {qsb, qsh, qsl, qsd};
  const long long ks[4] = {ksb, ksh, ksl, ksd};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == dft::DTYPE_F32)
    return (int)dft::dispatch_head_fwd<float>(q, k, v, o, b, h, lq, lk, d, qs,
                                              ks, scale, s);
  if (dtype == dft::DTYPE_BF16)
    return (int)dft::dispatch_head_fwd<__nv_bfloat16>(q, k, v, o, b, h, lq, lk,
                                                      d, qs, ks, scale, s);
  return (int)cudaErrorInvalidValue;
}
