// cholesky: L = chol(W), lower triangular, W (n, n) fp32 symmetric positive
// definite, any n. (The reference caps its kernel at n = 1024, the size its
// VMEM holds, and gives XLA the rest; nothing here needs that cap.)
//
// Replaces src/repro/kernels/cholesky.py:cholesky_pallas, a left-looking
// panel factorization (panels of 16) inside one kernel invocation, with W,
// L and the panel in VMEM (16 MB). On the H100 an n = 1024 fp32 W is 4 MB:
// it fits no block's 227 KB of shared memory, and one block would use one of
// 132 SMs for the O(n³) correction. So the panel loop moves to the host side
// of the C entry (one launch per panel on one stream, no host sync) and the
// matrices stay in device memory, which the 50 MB L2 holds. Each panel
// [c0, c0 + 16) is one launch of panel_kernel over a grid of
// (depth slices of t < c0) × (slabs of 64 rows i ≥ c0):
//
//   1. every block sums its slice of the correction of its rows,
//          part[k, i, c] = Σ_{t ∈ slice k} L[i, t]·L[c0 + c, t],
//      both operands staged in shared memory;
//   2. the last block of a slab to finish (an integer counter per slab;
//      the others exit) forms P = W[i, c0 + c] − Σ_k part[k, i, c] with
//      k ascending, factors the 16 × 16 diagonal block in one warp's
//      registers (the same bits in every slab: same inputs, same order),
//      and solves its rows against it. Column j of the panel subtracts the
//      earlier panel columns in ascending order, then takes the pivot d =
//      sqrt(max(p, 1e-30)) and scales the rows below it by 1/d, as the TPU
//      kernel divides them by d.
//
// Splitting the depth keeps the late panels, whose correction is long and
// whose rows are few, spread over many SMs (PERF.md §6 has the versions).
//
// Pivots are clamped at 1e-30 as in cholesky.py:63, so a W that is not
// positive definite gives finite garbage here, where the plain version
// (torch.linalg.cholesky, like jnp.linalg.cholesky) gives NaN; the two agree
// on SPD inputs only. A NaN pivot stays NaN. A ragged last panel (n % 16)
// is masked, which gives the same L as the reference's identity padding.
// The upper triangle is zeroed once, before the first panel.
//
// Bound: n³/3 flop (≈ 3.6·10⁸ at n = 1024, 5 µs at 67 TFLOP/s fp32) and
// 8n² bytes; in practice the n/16 dependent launches (64 at n = 1024) bound
// it — latency, not throughput. No float atomics and a fixed summation
// order: repeats are bit-identical.
#include "common.cuh"

namespace {

constexpr int kPanel = 16;       // mirrored in kernels/cholesky.py
constexpr int kSlab = 64;        // rows per block; mirrored in kernels/cholesky.py
constexpr int kDepth = 64;       // columns t of L per block; mirrored there too
constexpr int kThreads = 256;
constexpr int kLd = kDepth + 1;  // staged row stride (bank spread)

__device__ __forceinline__ float pivot(float p) {
  return sqrtf(isnan(p) ? p : fmaxf(p, 1e-30f));
}

__global__ void __launch_bounds__(kThreads)
panel_kernel(const float* __restrict__ W, float* __restrict__ L, float* part,
             float* dpart, unsigned int* counters, int n, int c0, int pw) {
  __shared__ float a[kSlab][kLd];         // L[row0 + r, t0 + kk]
  __shared__ float b[kPanel][kLd];        // L[c0 + c, t0 + kk]
  __shared__ float p[kSlab][kPanel + 1];  // corrected rows of the slab
  __shared__ float d[kPanel][kPanel + 1]; // the diagonal block, then its factor
  __shared__ float rd[kPanel];            // reciprocals of the factor's pivots
  __shared__ bool last;
  const int K = gridDim.x;
  const int k = blockIdx.x, slab = blockIdx.y;
  const int row0 = c0 + slab * kSlab;
  const int tid = threadIdx.x;

  // 1. this block's slice of the correction: 4 rows of the slab and one
  // element of the diagonal block per thread. Every slab sums the diagonal
  // block's slice itself (from the staged panel rows), so its last block
  // needs no other slab's partials.
  float* dslice = dpart + ((size_t)slab * K + k) * kPanel * kPanel;
  {
    const int c = tid & 15, r = tid >> 4;
    const int t0 = k * kDepth, t1 = min(c0, t0 + kDepth);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float dacc = 0.f;
    if (t0 < t1) {
#pragma unroll
      for (int q = 0; q < kSlab * kDepth / kThreads; ++q) {
        const int e = tid + kThreads * q, rr = e / kDepth, kk = e % kDepth;
        const int i = row0 + rr, t = t0 + kk;
        a[rr][kk] = (i < n && t < t1) ? L[(size_t)i * n + t] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kPanel * kDepth / kThreads; ++q) {
        const int e = tid + kThreads * q, cc = e / kDepth, kk = e % kDepth;
        const int t = t0 + kk;
        b[cc][kk] = (cc < pw && t < t1) ? L[(size_t)(c0 + cc) * n + t] : 0.f;
      }
      __syncthreads();
#pragma unroll 16
      for (int kk = 0; kk < kDepth; ++kk) {
        const float y = b[c][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(a[r + 16 * q][kk], y, acc[q]);
        dacc = fmaf(b[r][kk], y, dacc);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = row0 + r + 16 * q;
      if (i < n) part[((size_t)k * n + (i - c0)) * kPanel + c] = acc[q];
    }
    dslice[tid] = dacc;                      // kThreads == kPanel²
  }

  // 2. the last block of this slab finishes it
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[slab], 1u) == (unsigned)K - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) counters[slab] = 0;   // ready for the next panel's launch
  __threadfence();
  {
    // P = W − Σ_k partials (k ascending) for the thread's four elements of
    // the slab and one of the diagonal block, summed together so that
    // their loads (L2 hits) are in flight at once
    const int c = tid & 15, r = tid >> 4;
    const float* dsum = dpart + (size_t)slab * K * kPanel * kPanel + tid;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, ds = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float* pk = part + (size_t)kk * n * kPanel;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = row0 + r + 16 * q;
        if (i < n) s[q] += __ldcg(pk + (size_t)(i - c0) * kPanel + c);
      }
      ds += __ldcg(dsum + (size_t)kk * kPanel * kPanel);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = row0 + r + 16 * q;
      p[r + 16 * q][c] = (i < n && c < pw) ? W[(size_t)i * n + c0 + c] - s[q] : 0.f;
    }
    d[r][c] = (c0 + r < n && c < pw) ? W[(size_t)(c0 + r) * n + c0 + c] - ds : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    // warp 0 factors the diagonal block: lane l holds row l in registers,
    // column j's pivot and entries come by shuffle. Rows are scaled by the
    // pivot's reciprocal (within an ulp of the TPU kernel's division): a
    // division is a subroutine call on the dependency chain.
    const int l = tid;
    float x[kPanel];
#pragma unroll
    for (int c = 0; c < kPanel; ++c) x[c] = l < kPanel ? d[l][c] : 0.f;
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      if (j < pw) {
        const float dj = pivot(__shfl_sync(0xffffffffu, x[j], j));
        const float rj = __frcp_rn(dj);
        if (l > j) x[j] *= rj;
        if (l == j) {
          x[j] = dj;
          rd[j] = rj;
        }
#pragma unroll
        for (int q = j + 1; q < kPanel; ++q) {
          const float lqj = __shfl_sync(0xffffffffu, x[j], q);
          if (l >= q) x[q] -= x[j] * lqj;
        }
      }
    }
    if (l < kPanel) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) d[l][c] = x[c];
    }
  }
  __syncthreads();
  if (tid < kSlab) {                       // one row of the slab per thread
    const int i = row0 + tid;
    if (i < n) {
      float x[kPanel];
      const int l = i - c0;
      if (l < pw) {                        // inside the diagonal block
#pragma unroll
        for (int c = 0; c < kPanel; ++c) x[c] = c <= l ? d[l][c] : 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < kPanel; ++c) x[c] = p[tid][c];
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          if (j < pw) {
            x[j] *= rd[j];
#pragma unroll
            for (int q = j + 1; q < kPanel; ++q) x[q] -= x[j] * d[q][j];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c)
        if (c < pw) L[(size_t)i * n + c0 + c] = x[c];
    }
  }
}

}  // namespace

// W (n, n) fp32; scratch: S = ceil(n/64) slices of (n, 16) row partials,
// then S·S slices of (16, 16) diagonal partials (fp32), and S uint32 slab
// counters; L (n, n) fp32 output (every element is written). Two memsets
// and ceil(n/16) launches on `stream`.
extern "C" int cholesky_launch(const void* W, void* scratch, void* counters, void* L, int n,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const int slabs_max = (n + kSlab - 1) / kSlab;
  float* pp = static_cast<float*>(scratch);
  float* dp = pp + (size_t)slabs_max * n * kPanel;
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  float* l = static_cast<float*>(L);
  cudaError_t err = cudaMemsetAsync(l, 0, (size_t)n * n * sizeof(float), st);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(cnt, 0, (size_t)slabs_max * sizeof(unsigned int), st);
  if (err != cudaSuccess) return err;
  for (int c0 = 0; c0 < n; c0 += kPanel) {
    const int pw = n - c0 < kPanel ? n - c0 : kPanel;
    const int slices = c0 > 0 ? (c0 + kDepth - 1) / kDepth : 1;
    const dim3 grid(slices, (n - c0 + kSlab - 1) / kSlab);
    panel_kernel<<<grid, kThreads, 0, st>>>(w, l, pp, dp, cnt, n, c0, pw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
