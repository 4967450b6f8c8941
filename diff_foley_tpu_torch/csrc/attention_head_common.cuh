// Tile code of the per-head attention forward (attention_head_fwd.cu) over
// (B, H, L, D) operands of any dense strides. (The per-head backward,
// attention_head_bwd.cu, runs on the tensor cores: mma.cuh.)
//
// A block of 256 threads owns 32 query rows (HQ) of one (batch, head) and
// streams key tiles. Tiles are staged in shared memory as fp32, whatever
// the operand type, with leading dimension D + 4: float4-aligned, and the
// 16 rows a half-warp reads start 4 banks apart, so a 128-bit phase is
// conflict-free. Every product is an fp32 FMA.
//
// The VAE's tokens are an NCHW map seen as (B, 1, h·w, C): stride 1 along
// the tokens and h·w along D. Tile loads and stores walk the stride-1 axis
// with consecutive threads, so both layouts move coalesced and no
// transpose surrounds a call.
#pragma once

#include "common.cuh"

namespace dft {

constexpr int HQ = 32;    // query rows per block
constexpr int HNT = 256;  // threads per block

template <int D>
struct HeadTile {
  static constexpr int LD = D + 4;  // float4-aligned, rows 4 banks apart
};

// Rows [row0, row0 + rows) of one (b, h) operand as fp32 into dst (leading
// dimension ld); rows at or past L are zero. The stride-1 axis goes to
// consecutive threads.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long sl, long long sd,
                                          int row0, int rows, int L) {
  if (sd == 1) {
    for (int idx = threadIdx.x; idx < rows * D; idx += HNT) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int gr = row0 + r;
      dst[r * ld + c] = gr < L ? to_f<T>(src[gr * sl + c]) : 0.f;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += HNT) {
      const int c = idx / rows;
      const int r = idx - c * rows;
      const int gr = row0 + r;
      dst[r * ld + c] = gr < L ? to_f<T>(src[gr * sl + c * sd]) : 0.f;
    }
  }
}

// The first `rows` rows of an fp32 tile (leading dimension ld) to the rows
// of one (b, h) operand that start at dst, rounded to T; the stride-1 axis
// on consecutive threads.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long sl, long long sd,
                                           const float* src, int ld,
                                           int rows) {
  if (sd == 1) {
    for (int idx = threadIdx.x; idx < rows * D; idx += HNT) {
      const int r = idx / D;
      const int c = idx - r * D;
      dst[r * sl + c] = from_f<T>(src[r * ld + c]);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += HNT) {
      const int c = idx / rows;
      const int r = idx - c * rows;
      dst[r * sl + c * sd] = from_f<T>(src[r * ld + c]);
    }
  }
}

// s[a][b] = A(ty + 16a) · B(tx + 16b) for the thread's 2 x NB share of a
// (32, 16·NB) product of two tiles with D columns; ty = t / 16, tx = t % 16.
template <int D, int NB>
__device__ __forceinline__ void head_scores(const float* As, const float* Bs,
                                            float s[2][NB]) {
  constexpr int LD = HeadTile<D>::LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 qa[2], kb[NB];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      qa[a] = *reinterpret_cast<const float4*>(As + (ty + 16 * a) * LD + k);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      kb[b] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * b) * LD + k);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        s[a][b] = fmaf(qa[a].x, kb[b].x, s[a][b]);
        s[a][b] = fmaf(qa[a].y, kb[b].y, s[a][b]);
        s[a][b] = fmaf(qa[a].z, kb[b].z, s[a][b]);
        s[a][b] = fmaf(qa[a].w, kb[b].w, s[a][b]);
      }
  }
}

// reductions over the 16 lanes that share a score row
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace dft
