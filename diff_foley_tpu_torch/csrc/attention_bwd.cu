// Packed-heads softmax attention backward for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_packed_bwd_kernel
// (launched by _pallas_backward_packed, vjp _packed_bwd). The path runs it
// in the classifier guidance of every sampler step: the classifier's
// self- and cross-attention, B 4, 8 heads of D 32, L ≤ 256. Stage-2
// training runs it at the UNet's D 40/80/160, L ≤ 1024, the 1-D audio
// UNet's gradient at D 48 (L 2048) and 96 (L 1024), and the AR cond
// encoder's gradient at D 64 (32 video queries against themselves and
// against the previous window's 1024 latent tokens, H·D 512).
//
// q, k, v and the output gradient g are packed (B, L, H·D), exactly as the
// Linear layers emit them; head h of such an operand is the strided view
// (B, H, L, D) with strides (L·H·D, D, H·D, 1), which head_bwd.cuh's three
// launches read in place (a head's columns start h·D elements into a row:
// 16-byte aligned at every supported D in both types), so no transpose or
// copy surrounds the call. dQ, dK and dV are written in the packed layout.
// Numerics are the TPU kernel's: fp32 scores, P = e/Σe, P̃ cast to g's
// type before dV, dS cast to q's type, dK and dV summed in fp32; no
// atomics. In fp32 the products take the tile GEMM's precise mode (each
// 8-deep 3xTF32 product summed in fp32 round-to-nearest, the small parts
// rounded, the k-tiles added with compensation): fp32 sums in cuBLAS's
// order are themselves about 1e-5 of rms from exact at the classifier's
// shapes, the limit this kernel is held to there. Over at most 32 queries
// (the AR cond encoder's 32 video tokens) the whole backward runs in fp64
// (head_bwd.cuh::fp64_backward): there any fp32 sum of the scores leaves
// the heavy-tailed dK and dV 2-5e-5 of rms from exact.
//
// Bound on this card: 10·B·H·Lq·Lk·D operations (five products) against
// (3·Lq + 4·Lk)·B·H·D operand elements; at the classifier's shapes in
// bf16 that is byte-bound (1.1 µs for the operands of one (4, 256, 256)
// call). Between the launches the scores live in the scratch (12 bytes an
// entry in bf16: 25 MB at B 4, H 8, L 256), which stays in the 50 MB L2,
// so the time is the three launches' latency and the scratch's L2 traffic.
#include "head_bwd.cuh"

// q and g (b, lq, heads·d), k and v (b, lk, heads·d) as per-head strides in
// elements (batch, head, row, column), as for dft_attn_bwd: strides[0:4]
// q's (and dq's), [4:8] k's (and dk's), [8:12] v's (and dv's), [12:16] g's;
// addresses and strides other than 1 multiples of 16 bytes. scratch as for
// dft_attn_bwd: 2·b·heads·lq·lds fp32 and 2·b·heads·lq·lds operand
// elements, lds = lk rounded up to 8 (4·b·heads·lq·lds fp64 for fp32 over
// few queries or keys). Operands of one dtype (DTYPE_F32 or
// DTYPE_BF16); head dims 32, 40, 48, 64, 80, 96 and 160. Returns the cudaError_t of the
// launches; 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int dft_attn_packed_bwd(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, void* scratch, int b,
                                   int heads, int lq, int lk, int d,
                                   long long qsb, long long qsh, long long qsl,
                                   long long qsd, long long ksb, long long ksh,
                                   long long ksl, long long ksd, long long vsb,
                                   long long vsh, long long vsl, long long vsd,
                                   long long gsb, long long gsh, long long gsl,
                                   long long gsd, float scale, int dtype,
                                   void* stream) {
  if (!dft::supported_head_dim(d)) return (int)cudaErrorInvalidValue;
  const dft::Strides st[4] = {{qsb, qsh, qsl, qsd},
                              {ksb, ksh, ksl, ksd},
                              {vsb, vsh, vsl, vsd},
                              {gsb, gsh, gsl, gsd}};
  return dft::head_bwd(q, k, v, g, dq, dk, dv, scratch, b, heads, lq, lk,
                       d, st, scale, dtype, stream);
}
