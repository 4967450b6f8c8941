// The fp32 pieces of the packed-heads attention forward (attention_fwd.cu's
// fp32 kernel: the fp32 classifier, the 1-D audio UNet, EncoderUNetModel,
// the cond encoders' token transformer and the GPU-vs-CPU agreement of
// tiny pipelines).
//
// Operands are the projections exactly as the Linear layers emit them:
// packed (B, L, H*D), row-major and contiguous. A block owns one
// (batch, head, row tile); it reads its head's D columns straight out of
// the packed rows through strides, so no transpose or copy exists on
// either side of the call.
//
// Tiles are staged in shared memory as fp32, whatever the operand type,
// and every product is an fp32 FMA. bf16 operands are exact in fp32, so
// the products equal the tensor-core products of the plain version; only
// the order of the sums differs. Rows of a tile are padded to an odd
// leading dimension so that sixteen threads reading sixteen rows at one
// column hit sixteen banks.
#pragma once

#include "common.cuh"

namespace dft {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block
constexpr int SLD = BK + 1;   // leading dimension of (BQ, BK) score tiles

// odd leading dimension of a (rows, D) fp32 tile
__host__ __device__ __forceinline__ int tile_ld(int d) { return d | 1; }

// Stage rows [row0, row0 + rows) of one head of a packed (L, H*D) slab as
// fp32; rows past L are zero. Consecutive threads read consecutive
// columns of a row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int rows, int L, int hd,
                                          int col0, int d) {
  for (int idx = threadIdx.x; idx < rows * d; idx += NT) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < L ? to_f<T>(src[(size_t)gr * hd + col0 + c]) : 0.f;
  }
}

// acc = A Bᵀ for one thread's 4x4 share of a (64, 64) product of two
// (64, d) tiles. Thread t owns rows t/16 + 16a and columns t%16 + 16b.
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         int ld, int d, float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k = 0; k < d; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * ld + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(tx + 16 * b) * ld + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// acc[u] += Σ_j P(r, j) · V[j][c] for the thread's row r = t/4 and columns
// c = t%4 + 4u < d, over j < n. P(r, j) is P[r][j], or P[j][r] when trans.
template <int NC>
__device__ __forceinline__ void acc_pv(const float* P, bool trans,
                                       const float* V, int ld, int d, int n,
                                       float acc[NC]) {
  const int r = threadIdx.x >> 2;
  const int cg = threadIdx.x & 3;
  for (int j = 0; j < n; ++j) {
    const float p = trans ? P[j * SLD + r] : P[r * SLD + j];
    const float* vr = V + j * ld;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = cg + 4 * u;
      if (c < d) acc[u] = fmaf(p, vr[c], acc[u]);
    }
  }
}

// reductions over the 16 lanes that share a score row in tile_abt
__device__ __forceinline__ float row16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A row's reference max may trail its max by up to RESCALE_GAP: every
// exp(s·scale − reference) is then at most e¹⁶, so a row's sum stays far
// inside fp32's range at any length.
constexpr float RESCALE_GAP = 16.f;

// Row max m and row sum l of exp(s·scale − m) over all keys, for the
// thread's four rows of the query tile staged in Qs. Ks is scratch for
// the key tiles. Ends with every thread of a row holding its stats. The
// key tiles' sums are taken against a reference max that moves to a
// tile's max only when that passes it by more than RESCALE_GAP (the first
// tile always), so a row rescales about once, not at every new max; they
// are added with a compensation term (TwoSum), and the sum is brought to
// the row max m once at the end, in fp64. Rescaling and adding in fp32 at
// every new max drifted by a few ulps of l over the 32 key tiles of L
// 2048 (the 1-D audio UNet), which scales the row's output alike. m stays
// the row max: the second pass's exp(s·scale − m) then rounds as the
// plain version's does.
template <typename T>
__device__ __forceinline__ void row_stats(const float* Qs, float* Ks,
                                          const T* kb, int lk, int hd,
                                          int col0, int d, float scale,
                                          float m[4], float l[4]) {
  const int ld = tile_ld(d);
  const int tx = threadIdx.x & 15;
  float mr[4], lo[4];   // the reference maxima, l's compensation terms
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = mr[a] = -INFINITY;
    l[a] = lo[a] = 0.f;
  }
  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();
    load_tile<T>(Ks, ld, kb, k0, BK, lk, hd, col0, d);
    __syncthreads();
    float s[4][4];
    tile_abt(Qs, Ks, ld, d, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k0 + tx + 16 * b < lk) mx = fmaxf(mx, s[a][b] * scale);
      mx = row16_max(mx);
      m[a] = fmaxf(m[a], mx);
      // a select, not a branch: the branch cost D 96 a third of its time
      const bool up = mx > mr[a] + RESCALE_GAP;
      const float r = expf(up ? mr[a] - mx : 0.f);   // 1 unless up
      l[a] *= r;
      lo[a] *= r;
      mr[a] = up ? mx : mr[a];
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k0 + tx + 16 * b < lk) sum += expf(s[a][b] * scale - mr[a]);
      sum = row16_sum(sum);
      const float t = l[a] + sum, bt = t - l[a];
      lo[a] += (l[a] - (t - bt)) + (sum - bt);
      l[a] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    l[a] = (float)(((double)l[a] + (double)lo[a]) *
                   exp((double)mr[a] - (double)m[a]));
}

// The fp32 forward's least blocks an SM holds (its __launch_bounds__): at
// D ≤ 48 shared memory admits four or more, so three (80 registers a
// thread); above, shared memory or registers admit fewer.
__host__ __device__ constexpr int fwd_min_blocks(int nc) {
  return nc <= 12 ? 3 : 1;
}

}  // namespace dft

// Instantiate KERNEL_CALL with NC = d / 4 columns per thread, for each
// supported head dim d.
#define DFT_DISPATCH_NC(d, ...)                 \
  do {                                          \
    if ((d) == 32) {                            \
      constexpr int NC = 8;                     \
      __VA_ARGS__;                              \
    } else if ((d) == 40) {                     \
      constexpr int NC = 10;                    \
      __VA_ARGS__;                              \
    } else if ((d) == 48) {                     \
      constexpr int NC = 12;                    \
      __VA_ARGS__;                              \
    } else if ((d) == 64) {                     \
      constexpr int NC = 16;                    \
      __VA_ARGS__;                              \
    } else if ((d) == 80) {                     \
      constexpr int NC = 20;                    \
      __VA_ARGS__;                              \
    } else if ((d) == 96) {                     \
      constexpr int NC = 24;                    \
      __VA_ARGS__;                              \
    } else if ((d) == 160) {                    \
      constexpr int NC = 40;                    \
      __VA_ARGS__;                              \
    }                                           \
  } while (0)
