// fold_cols: the fold cross columns of one FIFO window update,
//
//   cols   = S · rowsᵀ      (n, k)
//   corner = rows · rowsᵀ   (k, k)
//
// Replaces src/repro/kernels/fold.py:fold_cols_pallas (_fold_cols_kernel).
// On the TPU both accumulators sit in VMEM over one sequential m sweep. Here
// the cross pass of cross.cuh runs over n + k "virtual rows" (the window's n
// rows, then the k fold rows) against the k-major fold rows, so the corner
// comes out of the same launch and pass over `rows`. The m axis is split over
// the SMs and the partials are summed in fixed order by a second launch.
//
// Bound: bytes (the window is read once; n*m elements at fp32 or bf16), read
// 16 bytes a lane where the window and the rows are aligned (stream.cuh).
// S and rows share the window storage dtype (the fold's single cast point
// rounds rows to it); accumulation is fp32.
#include "cross.cuh"

namespace {

template <typename T>
int fold_cols_impl(const void* S, const void* rows, void* part, void* out, int n, int m,
                   int k, int P, int chunk, int vec, cudaStream_t st) {
  cudaError_t err = repro::launch_cross<T, T, true>(
      static_cast<const T*>(S), n, static_cast<const T*>(rows), k,
      static_cast<const T*>(rows), m, k, P, chunk, vec, static_cast<float*>(part), st);
  if (err != cudaSuccess) return err;
  return repro::launch_reduce(static_cast<const float*>(part), P, (n + k) * k,
                              static_cast<float*>(out), st);
}

}  // namespace

// out: (n + k, k) fp32 — rows [0, n) are cols, rows [n, n + k) the corner.
// part: (P, n + k, k) fp32 scratch; vec the load route (1: 16 bytes a lane,
// S and rows both 16-byte aligned).
extern "C" int fold_cols_launch(const void* S, const void* rows, int bf16, void* part,
                                void* out, int n, int m, int k, int P, int chunk, int vec,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fold_cols_impl<__nv_bfloat16>(S, rows, part, out, n, m, k, P, chunk, vec, st)
              : fold_cols_impl<float>(S, rows, part, out, n, m, k, P, chunk, vec, st);
}
