// Split-m cross pass shared by serve_solve.cu and fold.cu.
//
//   part[p, i, c] = sum_{j in chunk p} X_i[j] * Y_c[j]
//
// X_i is row i of an (n, m) row-major window (fp32 or bf16), optionally
// followed by the rows of a second (n2, m) matrix of the same dtype (the fold
// kernel's corner rows). Y_c is column c of V (m, k) fp32 row-major, or row c
// of a (k, m) matrix ("k-major", the fold rows). Accumulation is fp32.
//
// The TPU kernels run this reduction over m as one sequential grid. Here the
// m axis is split into P chunks so the work spreads over every SM even when
// n is 8; the P partial sums are added in a fixed order by a second pass
// (reduce_partials_kernel, or the substitution kernel for serve_solve), never
// with float atomics, so a repeated call is bit-identical.
//
// Bound: device-memory bytes. Each window element is read once (k/2 flop per
// byte at fp32, far below the ~20 flop/byte where fp32 FMA would bind). Loads
// are scalar and coalesced across the warp (one element per lane per row), so
// any m works, including widths that break 16-byte vector loads.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kCrossThreads = 256;   // 8 warps
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = 32;    // 8 warps x 4 rows; mirrored in Python
constexpr int kTileJ = 128;          // m columns per stage, 4 per lane; mirrored in Python

template <typename TX, typename TY, bool Y_KMAJOR, int KT>
__global__ void __launch_bounds__(kCrossThreads)
cross_partial_kernel(const TX* __restrict__ X, int n_x,
                     const TX* __restrict__ X2, int n_x2,
                     const TY* __restrict__ Y, int m, int k, int chunk,
                     float* __restrict__ part) {
  // Y tile as fp32, column-padded so the per-lane reads of a row hit 32 banks
  __shared__ float ys[KT][kTileJ + 1];
  const int rows = n_x + n_x2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int p = blockIdx.y;
  const int c0 = blockIdx.z * KT;
  const int j_begin = p * chunk;
  const int j_end = min(m, j_begin + chunk);

  const TX* xrow[kRowsPerWarp];
  bool valid[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    valid[r] = i < rows;
    xrow[r] = !valid[r] ? X
              : (i < n_x ? X + (size_t)i * m : X2 + (size_t)(i - n_x) * m);
  }

  float acc[kRowsPerWarp][KT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTileJ) {
    for (int e = threadIdx.x; e < KT * kTileJ; e += kCrossThreads) {
      // k-major Y: consecutive threads walk j (coalesced); V (m, k): they
      // walk c within one row of V (coalesced when k fills the tile)
      const int c = Y_KMAJOR ? e / kTileJ : e % KT;
      const int jj = Y_KMAJOR ? e % kTileJ : e / KT;
      const int j = j0 + jj, cg = c0 + c;
      float y = 0.f;
      if (j < j_end && cg < k)
        y = Y_KMAJOR ? to_f32(Y[(size_t)cg * m + j]) : to_f32(Y[(size_t)j * k + cg]);
      ys[c][jj] = y;
    }
    __syncthreads();
    float xv[kRowsPerWarp][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = j0 + lane + 32 * t;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        xv[r][t] = (valid[r] && j < j_end) ? to_f32(xrow[r][j]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float y = ys[c][lane + 32 * t];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(xv[r][t], y, acc[r][c]);
      }
    __syncthreads();
  }

  // fixed butterfly order: lane 0's sum is the same on every run
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][c] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!valid[r]) continue;
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (c0 + c < k) part[((size_t)p * rows + row0 + r) * k + c0 + c] = acc[r][c];
    }
  }
}

// out[e] = sum_p part[p, e], p ascending: the fixed-order second pass.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int P,
                                       int count, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * count + e];
  out[e] = s;
}

template <typename TX, typename TY, bool Y_KMAJOR>
cudaError_t launch_cross(const TX* X, int n_x, const TX* X2, int n_x2, const TY* Y,
                         int m, int k, int P, int chunk, float* part, cudaStream_t st) {
  const int kt = k_tile(k);
  const dim3 grid((n_x + n_x2 + kRowsPerBlock - 1) / kRowsPerBlock, P, (k + kt - 1) / kt);
  switch (kt) {
    case 1:
      cross_partial_kernel<TX, TY, Y_KMAJOR, 1><<<grid, kCrossThreads, 0, st>>>(
          X, n_x, X2, n_x2, Y, m, k, chunk, part);
      break;
    case 4:
      cross_partial_kernel<TX, TY, Y_KMAJOR, 4><<<grid, kCrossThreads, 0, st>>>(
          X, n_x, X2, n_x2, Y, m, k, chunk, part);
      break;
    case 8:
      cross_partial_kernel<TX, TY, Y_KMAJOR, 8><<<grid, kCrossThreads, 0, st>>>(
          X, n_x, X2, n_x2, Y, m, k, chunk, part);
      break;
    default:
      cross_partial_kernel<TX, TY, Y_KMAJOR, 16><<<grid, kCrossThreads, 0, st>>>(
          X, n_x, X2, n_x2, Y, m, k, chunk, part);
  }
  return cudaGetLastError();
}

inline cudaError_t launch_reduce(const float* part, int P, int count, float* out,
                                 cudaStream_t st) {
  reduce_partials_kernel<<<(count + 255) / 256, 256, 0, st>>>(part, P, count, out);
  return cudaGetLastError();
}

}  // namespace repro
