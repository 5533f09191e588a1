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
//   1. cross pass (cross.cuh): split-m partials of U = S·V over every SM
//      (on the tensor cores for a bf16 window at 8 or 16 columns of V);
//   2. trisolve_kernel (trisolve.cuh): sums the partials in fixed order,
//      then solves L y = u and Lᵀ w = y by panels of 64 rows spread over a
//      cluster of 8 blocks, up to 16 RHS columns a cluster (L read once);
//   3. serve_apply_kernel (apply.cuh): X = (V − Sᵀw)/λ, the block's warps
//      splitting the rows of a strip of 128 columns.
//
// Bounds: passes 1 and 3 each read the window once (bytes; k/2 flop per byte
// at fp32), and pass 3 needs all of u first, so the chain reads the window
// twice: a 410 MB window does not stay in 50 MB of L2. Both passes read 16
// bytes a lane on the vector route (stream.cuh; `vec` below, chosen by
// serve_solve.stream_route). The substitution has 2n dependent steps and is
// latency-bound: trisolve.cuh says how it shortens that chain.
#include "apply.cuh"
#include "cross.cuh"
#include "trisolve.cuh"

namespace {

template <typename TS>
int serve_solve_impl(const void* S, const void* L, const void* V, void* part, void* w,
                     void* X, int n, int m, int k, int P, int chunk, int kt, float lam,
                     int per, int vec, cudaStream_t st) {
  const TS* s = static_cast<const TS*>(S);
  const float* v = static_cast<const float*>(V);
  cudaError_t err = repro::launch_cross<TS, float, false>(s, n, s, 0, v, m, k, P, chunk, vec,
                                                          static_cast<float*>(part), st);
  if (err != cudaSuccess) return err;
  err = repro::launch_trisolve(static_cast<const float*>(L),
                               static_cast<const float*>(part), P, n, k, kt,
                               static_cast<float*>(w), st);
  if (err != cudaSuccess) return err;
  return repro::launch_apply<TS, float>(s, static_cast<const float*>(w), v,
                                        static_cast<float*>(X), n, m, k, lam, per, vec,
                                        st);
}

}  // namespace

// S (n, m) fp32|bf16; V (m, k) fp32; part (P, n, k) scratch; U (n, k); vec
// the load route (1: 16 bytes a lane).
extern "C" int sv_cross_launch(const void* S, int bf16, const void* V, void* part, void* U,
                               int n, int m, int k, int P, int chunk, int vec,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(V);
  cudaError_t err =
      bf16 ? repro::launch_cross<__nv_bfloat16, float, false>(
                 static_cast<const __nv_bfloat16*>(S), n, static_cast<const __nv_bfloat16*>(S),
                 0, v, m, k, P, chunk, vec, static_cast<float*>(part), st)
           : repro::launch_cross<float, float, false>(
                 static_cast<const float*>(S), n, static_cast<const float*>(S), 0, v, m, k, P,
                 chunk, vec, static_cast<float*>(part), st);
  if (err != cudaSuccess) return err;
  return repro::launch_reduce(static_cast<const float*>(part), P, n * k,
                              static_cast<float*>(U), st);
}

// S (n, m) fp32|bf16; w (n, k), V (m, k), X (m, k) fp32; per the strips a
// block walks; vec the load route.
extern "C" int serve_apply_launch(const void* S, int bf16, const void* w, const void* V,
                                  void* X, int n, int m, int k, float lam, int per, int vec,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* v = static_cast<const float*>(V);
  float* x = static_cast<float*>(X);
  return bf16 ? repro::launch_apply<__nv_bfloat16, float>(
                    static_cast<const __nv_bfloat16*>(S), wp, v, x, n, m, k, lam, per, vec,
                    st)
              : repro::launch_apply<float, float>(static_cast<const float*>(S), wp, v, x, n, m,
                                                  k, lam, per, vec, st);
}

// L (n, n) fp32 lower; part (P, n, k) fp32 partials of u; w (n, k) fp32; kt
// the columns a cluster takes.
extern "C" int trisolve_launch(const void* L, const void* part, int P, int n, int k, int kt,
                               void* w, void* stream) {
  return repro::launch_trisolve(static_cast<const float*>(L),
                                static_cast<const float*>(part), P, n, k, kt,
                                static_cast<float*>(w), static_cast<cudaStream_t>(stream));
}

// The fused chain: cross partials -> substitution -> apply, one stream.
extern "C" int serve_solve_launch(const void* S, int bf16, const void* L, const void* V,
                                  void* part, void* w, void* X, int n, int m, int k, int P,
                                  int chunk, int kt, float lam, int per, int vec,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? serve_solve_impl<__nv_bfloat16>(S, L, V, part, w, X, n, m, k, P, chunk, kt,
                                                lam, per, vec, st)
              : serve_solve_impl<float>(S, L, V, part, w, X, n, m, k, P, chunk, kt, lam, per,
                                        vec, st);
}
