// Per-head softmax attention backward over (B, H, L, D) for Hopper (sm_90a).
//
// Replaces diff_foley_tpu/ops/pallas_attention.py::_attn_bwd_kernel
// (launched by _pallas_backward, vjp _bwd of flash_attention). The path
// runs it in the VAE's single-head mid attention (B, 1, 1024, 512) of the
// first-stage train step, encoder and decoder, and the spec decoder's
// (B, 1, 16, 256) of train/stage2_decode.py, the diffusion prior's
// (B, 8, 16, 64) and EncoderUNetModel's attention pool (B, 8, 1, 65, 32);
// the tiny agreement VAEs at D 32, and LatentRescaler's (B, 1, 4096, 512).
// The three launches (scores, rows, products) are head_bwd.cuh's, shared
// with the packed backward (attention_bwd.cu), fp32 in the tile GEMM's
// precise mode, or in fp64 over at most 32 queries (the prior, the spec
// decoder, the pool); the scratch is 64 MB at (4, 1, 1024, 512) in fp32.
//
// Bound on this card: 10·B·H·Lq·Lk·D operations (five products) against
// (3·Lq + 4·Lk)·B·H·D operand elements: operation-bound at L 1024, D 512,
// at 989 TFLOP/s in bf16 and 495/3 = 165 TFLOP/s for fp32-accurate 3xTF32.
// The scratch traffic (S, dP written once and read by the row pass, P̃ and
// dS written once and read by the products) is ~100 MB at the train shape,
// mostly in L2. wgmma and TMA would reach more of the rate; later work.
#include "head_bwd.cuh"

// q and g (b, h, lq, d), k and v (b, h, lk, d), each with its own strides
// in elements (batch, head, row, column): strides[0:4] q's (and dq's),
// [4:8] k's (and dk's), [8:12] v's (and dv's), [12:16] g's. Each operand
// has stride 1 along its rows or its columns, its other strides and its
// address are multiples of 16 bytes. scratch holds 2·b·h·lq·lds fp32 and
// then 2·b·h·lq·lds operand elements, lds = lk rounded up to 8 (fp32 over
// few queries or keys, head_bwd.cuh::fp64_backward: 4·b·h·lq·lds fp64).
// Operands of
// one dtype (DTYPE_F32 or DTYPE_BF16); head dims 512, 256, 64 and 32. Returns
// the cudaError_t of the launches; 1 (cudaErrorInvalidValue) for arguments it
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
  if (d != 512 && d != 256 && d != 64 && d != 32)
    return (int)cudaErrorInvalidValue;
  const dft::Strides st[4] = {{qsb, qsh, qsl, qsd},
                              {ksb, ksh, ksl, ksd},
                              {vsb, vsh, vsl, vsd},
                              {gsb, gsh, gsl, gsd}};
  // head_bwd's fp32 products take the tile GEMM's precise mode, or fp64
  // over few queries: at one query (EncoderUNetModel's attention pool)
  // dQ = Σ_j dS_j·K_j sums terms of one sign-balanced row (Σ_j dS_j = 0),
  // which chained 3xTF32 sums leave ~2e-5 of rms from exact
  return dft::head_bwd(q, k, v, g, dq, dk, dv, scratch, b, h, lq, lk, d, st,
                       scale, dtype, stream);
}
