// Packed-heads softmax attention forward for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_packed_kernel
// (launched by _pallas_forward_packed, entry flash_attention_packed):
//   O[b, i, h·D:(h+1)·D] = softmax(Q_h K_hᵀ · scale) V_h
// over packed (B, L, H·D) operands, no mask.
//
// Numerics follow the TPU kernel: fp32 scores times scale, row max,
// P = e / Σe in fp32, P cast to V's type, fp32 P·V, output cast back.
// To keep that order exactly (normalise, then cast) the block makes two
// passes over the keys: the first finds each row's max and sum, the
// second forms the normalised P and accumulates P·V.
//
// Bound on this card: 4·B·H·Lq·Lk·D operations against (2·Lq + 2·Lk)·B·H·D
// operand elements. Against the card's ~295 bf16 operations per byte only
// Lq = Lk = 1024 (the UNet's level-0 self-attention) is operation-bound;
// every other path shape is byte-bound. This first kernel uses fp32 FMAs
// from shared memory and recomputes Q Kᵀ in its second pass; it is
// correct and simple, not fast. Tensor-core (mma/wgmma) tiles are later
// work.
#include "attention_common.cuh"

namespace dft {

// grid (ceil(Lq/BQ), H, B), NT threads
template <typename T, int NC>
__global__ void __launch_bounds__(NT)
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
// of one dtype (DTYPE_F32 or DTYPE_BF16). Returns the cudaError_t of the
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
    DFT_DISPATCH_NC(d, err = dft::launch_fwd<__nv_bfloat16, NC>(
                           q, k, v, o, b, lq, lk, heads, d, scale, s));
  }
  return (int)err;
}
