// Tensor-core building blocks of the attention kernels rebuilt for Hopper
// (attention_fwd.cu's bf16 path, head_gemm.cuh's tile GEMM of the per-head
// forward and backward): 16-byte cp.async copies, ldmatrix fragment loads,
// the mma.sync products, and the 3xTF32 split that keeps fp32 accuracy on
// the TF32 tensor cores.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k8, per lane: g = lane/4,
// t = lane%4). C and D, 16×8 fp32: c0, c1 at (row g, cols 2t, 2t+1), c2, c3
// at (row g+8, same cols). For bf16 (k16) A holds (g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..) and B (k 2t..2t+1, n g),
// (k 2t+8.., n g); so two neighbouring C tiles, rounded to bf16 in pairs,
// are exactly one A fragment. For tf32 (k8) A holds (g, t), (g+8, t),
// (g, t+4), (g+8, t+4) and B (k t, n g), (k t+4, n g).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace dft {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared; only the first src_bytes (0..16) are read, the
// rest of the 16 are zero-filled. With src_bytes 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a·b, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small + O(2⁻²¹|x|): big = x rounded to nearest (ties away
// from zero, as cvt.rna.tf32.f32) onto TF32's 10 mantissa bits, by adding
// half of the dropped 13 bits to the magnitude and clearing them (two
// integer operations where cvt.rna takes several); small = x − big,
// exact in fp32, which the tensor cores read truncated to TF32. big·big +
// big·small + small·big then carries the fp32 product to about 2⁻²¹; the
// small·small term left out is of order 2⁻²². With ROUND, small too is
// rounded to nearest onto TF32 rather than read truncated, which halves
// the error the split leaves.
template <bool ROUND = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
  if (ROUND) small = (small + 0x1000u) & 0xffffe000u;
}

// two fp32 values as one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace dft
