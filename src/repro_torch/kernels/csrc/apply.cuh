// The apply pass shared by serve_solve.cu (serve_apply, the third launch of
// serve_solve) and ngd_apply.cu:
//
//   X[j, c] = (V[j, c] − Σ_i S[i, j] w[i, c]) / λ
//
// S (n, m) row-major fp32 or bf16; w (n, k) fp32; V (m, k) fp32 or bf16,
// widened on load; X (m, k) fp32. The contraction runs over n, the strided
// axis of the row-major window: each thread owns one column j, so a warp's
// reads of S[i, j..j+31] are coalesced, and w is staged in shared memory (a
// broadcast read for every thread). The subtraction and 1/λ are fused, so the
// m-long Sᵀw never reaches device memory.
//
// Bound: device-memory bytes (the window is read once; k/2 flop per byte at
// fp32). Each output is one thread's sequential sum, so repeats are
// bit-identical.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kApplyThreads = 128;
constexpr int kApplyTileI = 128;   // rows of w staged per shared-memory tile

template <typename TS, typename TV, int KT>
__global__ void __launch_bounds__(kApplyThreads)
serve_apply_kernel(const TS* __restrict__ S, const float* __restrict__ w,
                   const TV* __restrict__ V, float* __restrict__ X, int n, int m, int k,
                   float lam) {
  __shared__ float ws[kApplyTileI][KT];
  const int j = blockIdx.x * kApplyThreads + threadIdx.x;
  const int c0 = blockIdx.y * KT;
  float acc[KT];
#pragma unroll
  for (int c = 0; c < KT; ++c) acc[c] = 0.f;
  for (int i0 = 0; i0 < n; i0 += kApplyTileI) {
    const int ti = min(kApplyTileI, n - i0);
    for (int e = threadIdx.x; e < kApplyTileI * KT; e += kApplyThreads) {
      const int ii = e / KT, c = e % KT, cg = c0 + c;
      ws[ii][c] = (ii < ti && cg < k) ? w[(size_t)(i0 + ii) * k + cg] : 0.f;
    }
    __syncthreads();
    if (j < m) {
      const TS* col = S + (size_t)i0 * m + j;
#pragma unroll 8
      for (int ii = 0; ii < ti; ++ii) {
        const float s = to_f32(col[(size_t)ii * m]);
#pragma unroll
        for (int c = 0; c < KT; ++c) acc[c] = fmaf(s, ws[ii][c], acc[c]);
      }
    }
    __syncthreads();
  }
  if (j < m) {
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      if (c0 + c >= k) break;
      const size_t o = (size_t)j * k + c0 + c;
      X[o] = (to_f32(V[o]) - acc[c]) / lam;
    }
  }
}

template <typename TS, typename TV>
cudaError_t launch_apply(const TS* S, const float* w, const TV* V, float* X, int n, int m,
                         int k, float lam, cudaStream_t st) {
  const int kt = k_tile(k);
  const dim3 grid((m + kApplyThreads - 1) / kApplyThreads, (k + kt - 1) / kt);
  switch (kt) {
    case 1:
      serve_apply_kernel<TS, TV, 1><<<grid, kApplyThreads, 0, st>>>(S, w, V, X, n, m, k, lam);
      break;
    case 4:
      serve_apply_kernel<TS, TV, 4><<<grid, kApplyThreads, 0, st>>>(S, w, V, X, n, m, k, lam);
      break;
    case 8:
      serve_apply_kernel<TS, TV, 8><<<grid, kApplyThreads, 0, st>>>(S, w, V, X, n, m, k, lam);
      break;
    default:
      serve_apply_kernel<TS, TV, 16><<<grid, kApplyThreads, 0, st>>>(S, w, V, X, n, m, k, lam);
  }
  return cudaGetLastError();
}

}  // namespace repro
