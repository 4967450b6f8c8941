// Pieces shared by every kernel of csrc/: the dtype codes of the Python
// wrappers, the conversions between the operand type and fp32, and the
// one-time raise of a kernel's dynamic shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <mutex>

namespace dft {

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// x rounded through T: the plain version's cast to the operand type
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f<T>(from_f<T>(x));
}

// The packed attention kernels' head dims: 32 in the classifier and the
// EncoderUNetModel; 40, 80 and 160 at the UNet's levels 0, 1 and 2 (160
// also in its middle block); 48 and 96 at the 1-D audio UNet's attention
// resolutions 2 and 4 (96 also in its middle block); 64 in the cond
// encoders' token transformer (TokenTransformerCond: the AR encoder's
// fusion net, 8 heads of 64).
__host__ __device__ constexpr bool supported_head_dim(int d) {
  return d == 32 || d == 40 || d == 48 || d == 64 || d == 80 || d == 96 ||
         d == 160;
}

// Raises a kernel's dynamic shared-memory limit to its fixed budget once
// per device, at its first launch there, rather than before every launch.
// A launcher keeps one static SmemLimit per kernel instantiation:
//   static SmemLimit limit;
//   err = limit.raise(kernel, BUDGET);
struct SmemLimit {
  static constexpr int kDevices = 64;
  std::once_flag once[kDevices];
  cudaError_t err[kDevices];

  template <typename K>
  cudaError_t raise(K kernel, size_t bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
    std::call_once(once[dev], [&] {
      err[dev] = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    });
    return err[dev];
  }
};

}  // namespace dft
