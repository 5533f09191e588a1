// The uniform-lambda serve request path against a resident factor L:
//
//   X = (V − Sᵀ L⁻ᵀ L⁻¹ S V) / λ
//
// Replaces src/repro/kernels/serve_solve.py: serve_solve_pallas (one
// invocation, grid (2, m/bk), U and w resident in VMEM, in-kernel _trisolve),
// sv_cross_pallas (U = S·V) and serve_apply_pallas (X = (V − Sᵀw)/λ).
//
// The TPU kernel keeps L (n, n) and both (n, k) intermediates in VMEM and runs
// its grid in order on one core. On the H100, L alone is 4 MB at n = 1024, far
// beyond a block's 227 KB of shared memory, and a sequential grid would use one
// SM. So the fusion is redrawn as three launches on one stream, with no host
// sync between them:
//
//   1. cross pass (cross.cuh): split-m partials of U = S·V over every SM;
//   2. trisolve_kernel: sums the partials in fixed order, then solves
//      L y = u and Lᵀ w = y by panels of 32 rows, one block per RHS column,
//      reading L from global memory (L2 holds it);
//   3. serve_apply_kernel (apply.cuh, shared with ngd_apply.cu):
//      X = (V − Sᵀw)/λ, one thread per column of S.
//
// Bounds: passes 1 and 3 each read the window once (bytes; k/2 flop per byte
// at fp32). The substitution has 2n dependent steps and is latency-bound: it
// batches 32 steps per panel inside one warp (shared memory and shuffles, no
// block barrier, pivot reciprocals off the dependency chain) and spreads each
// panel's trailing update over 1024 threads with coalesced reads of L.
#include "apply.cuh"
#include "cross.cuh"

namespace {

constexpr int kTriThreads = 1024;
constexpr int kPanel = 32;

// Warp 0 loads the diagonal block L[p0:p0+32, p0:p0+32] into shared memory
// (32 independent loads per lane, one latency) and returns, per lane, the
// reciprocal of its pivot: the 32 divisions run in parallel, off the chain.
__device__ __forceinline__ float stage_diag(const float* __restrict__ L, int n, int p0, int pw,
                                            float (*d)[kPanel + 1], int lane) {
#pragma unroll
  for (int a = 0; a < kPanel; ++a)
    d[a][lane] = (a < pw && lane < pw) ? L[(size_t)(p0 + a) * n + p0 + lane] : 0.f;
  __syncwarp();
  return lane < pw ? 1.f / d[lane][lane] : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// w[:, c] = L⁻ᵀ L⁻¹ u[:, c] with u[i, c] = Σ_p part[p, i, c] (p ascending).
// One block per column c; the RHS lives in dynamic shared memory (n floats).
// Each panel of 32 rows: warp 0 stages the diagonal block and solves it with
// shuffles (no block barrier), then all 32 warps apply the panel to the
// remaining rows with coalesced reads of L — forward: one warp per row, lanes
// across the panel's columns, a fixed-order shuffle sum; backward: one thread
// per row, the warp reading consecutive columns.
__global__ void __launch_bounds__(kTriThreads)
trisolve_kernel(const float* __restrict__ L, const float* __restrict__ part, int P, int n,
                int k, float* __restrict__ w) {
  constexpr int kWarps = kTriThreads / 32;
  extern __shared__ float r[];
  __shared__ float d[kPanel][kPanel + 1];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < n; i += kTriThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[((size_t)p * n + i) * k + c];
    r[i] = s;
  }
  __syncthreads();

  // forward: L y = u, panels top to bottom
  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int pw = min(kPanel, n - p0);
    if (warp == 0) {
      const float dinv = stage_diag(L, n, p0, pw, d, lane);
      float x = lane < pw ? r[p0 + lane] : 0.f;
      for (int t = 0; t < pw; ++t) {
        if (lane == t) x *= dinv;
        const float yt = __shfl_sync(0xffffffffu, x, t);
        if (lane > t) x = fmaf(-d[lane][t], yt, x);
      }
      if (lane < pw) r[p0 + lane] = x;
    }
    __syncthreads();
    const float y = lane < pw ? r[p0 + lane] : 0.f;
#pragma unroll 4
    for (int i = p0 + pw + warp; i < n; i += kWarps) {
      const float a = lane < pw ? L[(size_t)i * n + p0 + lane] : 0.f;
      const float s = warp_sum(a * y);
      if (lane == 0) r[i] -= s;
    }
    __syncthreads();
  }

  // backward: Lᵀ w = y, panels bottom to top
  for (int p0 = ((n - 1) / kPanel) * kPanel; p0 >= 0; p0 -= kPanel) {
    const int pw = min(kPanel, n - p0);
    if (warp == 0) {
      const float dinv = stage_diag(L, n, p0, pw, d, lane);
      float x = lane < pw ? r[p0 + lane] : 0.f;
      for (int t = pw - 1; t >= 0; --t) {
        if (lane == t) x *= dinv;
        const float wt = __shfl_sync(0xffffffffu, x, t);
        if (lane < t) x = fmaf(-d[t][lane], wt, x);
      }
      if (lane < pw) r[p0 + lane] = x;
    }
    __syncthreads();
    const float* col = L + (size_t)p0 * n;
    const float* wp = r + p0;
    for (int i = tid; i < p0; i += kTriThreads) {
      // a full panel is unrolled so its 32 loads are in flight together,
      // with four accumulators to break the FMA chain
      float acc;
      if (pw == kPanel) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int t = 0; t < kPanel; t += 4) {
          s0 = fmaf(col[(size_t)(t + 0) * n + i], wp[t + 0], s0);
          s1 = fmaf(col[(size_t)(t + 1) * n + i], wp[t + 1], s1);
          s2 = fmaf(col[(size_t)(t + 2) * n + i], wp[t + 2], s2);
          s3 = fmaf(col[(size_t)(t + 3) * n + i], wp[t + 3], s3);
        }
        acc = (s0 + s1) + (s2 + s3);
      } else {
        acc = 0.f;
        for (int t = 0; t < pw; ++t) acc = fmaf(col[(size_t)t * n + i], wp[t], acc);
      }
      r[i] -= acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kTriThreads) w[(size_t)i * k + c] = r[i];
}

cudaError_t launch_trisolve(const float* L, const float* part, int P, int n, int k, float* w,
                            cudaStream_t st) {
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trisolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  trisolve_kernel<<<k, kTriThreads, smem, st>>>(L, part, P, n, k, w);
  return cudaGetLastError();
}

template <typename TS>
int serve_solve_impl(const void* S, const void* L, const void* V, void* part, void* w,
                     void* X, int n, int m, int k, int P, int chunk, float lam,
                     cudaStream_t st) {
  const TS* s = static_cast<const TS*>(S);
  const float* v = static_cast<const float*>(V);
  cudaError_t err = repro::launch_cross<TS, float, false>(s, n, s, 0, v, m, k, P, chunk,
                                                          static_cast<float*>(part), st);
  if (err != cudaSuccess) return err;
  err = launch_trisolve(static_cast<const float*>(L), static_cast<const float*>(part), P,
                        n, k, static_cast<float*>(w), st);
  if (err != cudaSuccess) return err;
  return repro::launch_apply<TS, float>(s, static_cast<const float*>(w), v,
                                        static_cast<float*>(X), n, m, k, lam, st);
}

}  // namespace

// S (n, m) fp32|bf16; V (m, k) fp32; part (P, n, k) scratch; U (n, k).
extern "C" int sv_cross_launch(const void* S, int bf16, const void* V, void* part, void* U,
                               int n, int m, int k, int P, int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(V);
  cudaError_t err =
      bf16 ? repro::launch_cross<__nv_bfloat16, float, false>(
                 static_cast<const __nv_bfloat16*>(S), n, static_cast<const __nv_bfloat16*>(S),
                 0, v, m, k, P, chunk, static_cast<float*>(part), st)
           : repro::launch_cross<float, float, false>(
                 static_cast<const float*>(S), n, static_cast<const float*>(S), 0, v, m, k, P,
                 chunk, static_cast<float*>(part), st);
  if (err != cudaSuccess) return err;
  return repro::launch_reduce(static_cast<const float*>(part), P, n * k,
                              static_cast<float*>(U), st);
}

// S (n, m) fp32|bf16; w (n, k), V (m, k), X (m, k) fp32.
extern "C" int serve_apply_launch(const void* S, int bf16, const void* w, const void* V,
                                  void* X, int n, int m, int k, float lam, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* v = static_cast<const float*>(V);
  float* x = static_cast<float*>(X);
  return bf16 ? repro::launch_apply<__nv_bfloat16, float>(
                    static_cast<const __nv_bfloat16*>(S), wp, v, x, n, m, k, lam, st)
              : repro::launch_apply<float, float>(static_cast<const float*>(S), wp, v, x, n, m,
                                                  k, lam, st);
}

// L (n, n) fp32 lower; part (P, n, k) fp32 partials of u; w (n, k) fp32.
extern "C" int trisolve_launch(const void* L, const void* part, int P, int n, int k, void* w,
                               void* stream) {
  return launch_trisolve(static_cast<const float*>(L), static_cast<const float*>(part), P, n,
                         k, static_cast<float*>(w), static_cast<cudaStream_t>(stream));
}

// The fused chain: cross partials -> substitution -> apply, one stream.
extern "C" int serve_solve_launch(const void* S, int bf16, const void* L, const void* V,
                                  void* part, void* w, void* X, int n, int m, int k, int P,
                                  int chunk, float lam, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? serve_solve_impl<__nv_bfloat16>(S, L, V, part, w, X, n, m, k, P, chunk, lam,
                                                st)
              : serve_solve_impl<float>(S, L, V, part, w, X, n, m, k, P, chunk, lam, st);
}
