// ngd_apply: the second and last pass over S of Algorithm 1,
//
//   x = (v − Sᵀw) / λ        S (n, m) fp32|bf16; w (n,) fp32; v (m,) fp32|bf16
//
// Replaces src/repro/kernels/ngd_apply.py:ngd_apply_pallas. The TPU kernel
// holds an (n, bk) tile of S in VMEM and contracts its sublane axis on the
// MXU; here the apply pass of apply.cuh runs at k = 1 with v in its own
// storage dtype (bf16 is widened on load, as the TPU kernel casts v to fp32
// in-kernel) and an fp32 output. One thread owns one column of S, so a warp
// reads 32 neighbouring elements of a row; w (n floats) is staged through
// shared memory, and the subtraction and 1/λ are fused.
//
// Bound: device-memory bytes, n·m·sizeof(S) + m·(sizeof(v) + 4) ≈ 0.12 ms at
// (1024, 100,000) fp32 on an H100 (2 flop per window element, far below the
// fp32 FMA rate's ~20 flop per byte).
#include "apply.cuh"

extern "C" int ngd_apply_launch(const void* S, int s_bf16, const void* w, const void* v,
                                int v_bf16, void* x, int n, int m, float lam, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  float* xp = static_cast<float*>(x);
  using bf16 = __nv_bfloat16;
  if (s_bf16) {
    const bf16* s = static_cast<const bf16*>(S);
    return v_bf16 ? repro::launch_apply<bf16, bf16>(s, wp, static_cast<const bf16*>(v), xp,
                                                    n, m, 1, lam, st)
                  : repro::launch_apply<bf16, float>(s, wp, static_cast<const float*>(v), xp,
                                                     n, m, 1, lam, st);
  }
  const float* s = static_cast<const float*>(S);
  return v_bf16 ? repro::launch_apply<float, bf16>(s, wp, static_cast<const bf16*>(v), xp, n,
                                                   m, 1, lam, st)
                : repro::launch_apply<float, float>(s, wp, static_cast<const float*>(v), xp, n,
                                                    m, 1, lam, st);
}
