// The multi-RHS apply pass of serve_solve.cu (serve_apply, and the third
// launch of serve_solve):
//
//   X[j, c] = (V[j, c] − Σ_i S[i, j] w[i, c]) / λ
//
// S (n, m) row-major fp32 or bf16; w (n, k) fp32; V (m, k) fp32, widened on
// load; X (m, k) fp32. The contraction runs over n, the strided axis of the
// row-major window. One right-hand side has a kernel of its own
// (ngd_apply.cu); this one carries that kernel's design over to KT ∈ {1, 4,
// 8, 16} columns of w a block.
//
// Bound: device-memory bytes, n·m·sizeof(S) + the small w, V and X (k/2 flop
// per byte at fp32), ≈ 0.124 ms at (1024, 100,000, k = 8) fp32 on an H100.
// It streams at that rate only with many bytes a lane in flight, so:
//
// * Wide loads (stream.cuh): a lane reads 16 bytes of a row with
//   ld.global.nc.L1::no_allocate; an unaligned window takes scalar loads of
//   the same columns (serve_solve.stream_route in Python).
// * Four columns a lane: a block's strip is 128 columns, columns 4l … 4l + 3
//   lane l's, so its sums are 4·KT registers in both dtypes. A bf16 load is
//   8 columns: lanes 2q and 2q + 1 load rows 2g and 2g + 1 of the same 8
//   columns and swap halves with one pair of shuffles.
// * Rows split across warps: the 8 warps of a block read the same strip,
//   warp v the row groups v, v + 8, … (a group is the 1 or 2 rows a lane's
//   load covers), apply_loads() loads a lane at a time with the next ones
//   in flight on the vector route; w is staged in shared memory once (n·KT ≤ 16,384 floats; else a
//   slab at a time). The 8 partial sums of a column are added in warp order
//   through shared memory, so a repeat is bit-identical.
// * Even load: at most 264 blocks (2 resident on each of an H100's 132 SMs,
//   one wave), each walking the same number of consecutive strips; the
//   split follows from m alone, never from the card.
// * The subtraction and 1/λ are fused into the column's last write.
//
// The order (each warp's rows ascending, then the warps in order) depends on
// the shape and the dtype only; ref.serve_apply_warps_ref emulates it.
#pragma once

#include "stream.cuh"

namespace repro {

constexpr int kApplyWarps = 8;
constexpr int kApplyThreads = 32 * kApplyWarps;
constexpr int kApplyStrip = 128;          // columns a strip; mirrored in Python
constexpr int kApplyMaxBlocks = 264;      // a bound on serve_solve.apply_split
constexpr int kApplySlabFloats = 16384;   // w staged at a time: 64 KB at most

// a lane's loads of an iteration: 8, 4 at KT = 16 (its sums take 64
// registers)
template <int KT>
__host__ __device__ constexpr int apply_loads() {
  return KT <= 8 ? 8 : 4;
}

template <int KT>
struct ApplyCfg {
  static constexpr int kRed = KT < 8 ? KT : 8;    // columns of w a round of the warps' sum
  // the sum's rows: 16-byte stores of a warp, reads of 32 (column, c) pairs
  // on 32 banks
  static constexpr int kRedPitch = kApplyStrip + (kRed > 1 ? 32 / kRed : 0);
  static constexpr int kSlabRows = kApplySlabFloats / KT;
};

// rows of w staged at a time: n rounded up to 16 (the rows one load of every
// warp covers), at most kSlabRows
template <int KT>
__host__ __device__ inline int apply_slab(int n) {
  const int rows = (n + 15) / 16 * 16;
  return rows < ApplyCfg<KT>::kSlabRows ? rows : ApplyCfg<KT>::kSlabRows;
}

template <int KT>
__host__ __device__ inline int apply_smem_bytes(int n) {
  using Cfg = ApplyCfg<KT>;
  return 4 * (apply_slab<KT>(n) * KT + kApplyWarps * Cfg::kRed * Cfg::kRedPitch);
}

// ws[i][c] = w[i0 + i, c0 + c] for i < slab; zero past `rows` or k
template <int KT>
__device__ __forceinline__ void stage_w(float* ws, const float* __restrict__ w, int i0,
                                        int rows, int slab, int k, int c0) {
  for (int e = threadIdx.x; e < slab * KT; e += kApplyThreads) {
    const int i = e / KT, c = e % KT;
    ws[e] = i < rows && c0 + c < k ? w[(size_t)(i0 + i) * k + c0 + c] : 0.f;
  }
}

// acc[t][c] += x_t · w_r[c] for the lane's 4 columns of one row
template <int KT>
__device__ __forceinline__ void apply_row(float (&acc)[4][KT], float x0, float x1, float x2,
                                          float x3, const float* wr) {
#pragma unroll
  for (int c4 = 0; c4 < KT; c4 += 4) {
    float wv[4];
    if constexpr (KT >= 4) {
      const float4 q = *reinterpret_cast<const float4*>(wr + c4);
      wv[0] = q.x, wv[1] = q.y, wv[2] = q.z, wv[3] = q.w;
    } else {
      wv[0] = wr[0];
    }
#pragma unroll
    for (int c = 0; c < (KT < 4 ? KT : 4); ++c) {
      acc[0][c4 + c] = fmaf(x0, wv[c], acc[0][c4 + c]);
      acc[1][c4 + c] = fmaf(x1, wv[c], acc[1][c4 + c]);
      acc[2][c4 + c] = fmaf(x2, wv[c], acc[2][c4 + c]);
      acc[3][c4 + c] = fmaf(x3, wv[c], acc[3][c4 + c]);
    }
  }
}

// One lane load of row group g: fp32, the lane's 4 columns of row g; bf16,
// 8 columns of row 2g + b, swapped with the partner lane for its 4 columns
// of rows 2g and 2g + 1, taken in that order. wg points at w's row of the
// group's first row.
template <typename TS, int KT>
__device__ __forceinline__ void apply_group(float (&acc)[4][KT], const uint4& r, int b,
                                            const float* wg) {
  if constexpr (sizeof(TS) == 4) {
    apply_row<KT>(acc, __uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
                  __uint_as_float(r.w), wg);
  } else {
    const uint32_t q0 = __shfl_xor_sync(0xffffffffu, b ? r.x : r.z, 1);
    const uint32_t q1 = __shfl_xor_sync(0xffffffffu, b ? r.y : r.w, 1);
    const uint32_t a0 = b ? q0 : r.x, a1 = b ? q1 : r.y;   // row 2g
    const uint32_t e0 = b ? r.z : q0, e1 = b ? r.w : q1;   // row 2g + 1
    apply_row<KT>(acc, stream::lo(a0), stream::hi(a0), stream::lo(a1), stream::hi(a1), wg);
    apply_row<KT>(acc, stream::lo(e0), stream::hi(e0), stream::lo(e1), stream::hi(e1),
                  wg + KT);
  }
}

template <typename TS, typename TV, int KT, bool VEC>
__global__ void __launch_bounds__(kApplyThreads, 2)
serve_apply_kernel(const TS* __restrict__ S, const float* __restrict__ w,
                   const TV* __restrict__ V, float* __restrict__ X, int n, int m, int k,
                   int per, float lam) {
  using Cfg = ApplyCfg<KT>;
  constexpr int kVec = stream::Lane<TS>::kVec;
  constexpr int G = kVec / 4;             // rows a lane's load serves
  constexpr int U = apply_loads<KT>();
  constexpr int W = kApplyWarps;
  extern __shared__ __align__(16) float apply_smem[];
  const int slab = apply_slab<KT>(n);
  float* ws = apply_smem;                               // [slab][KT]
  float* red = apply_smem + slab * KT;                  // [W][kRed][kRedPitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = lane % G;                               // the row of a group it loads
  const int jl = kVec * (lane / G);                     // its load's column in a strip
  const int c0 = blockIdx.y * KT;
  const int strips = (m + kApplyStrip - 1) / kApplyStrip;
  const int strip_end = min(strips, ((int)blockIdx.x + 1) * per);
  const bool once = n <= slab;
  if (once) {
    stage_w<KT>(ws, w, 0, n, slab, k, c0);
    __syncthreads();
  }
  for (int strip = (int)blockIdx.x * per; strip < strip_end; ++strip) {
    const int j = strip * kApplyStrip + jl;
    float acc[4][KT];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < KT; ++c) acc[t][c] = 0.f;
    for (int i0 = 0; i0 < n; i0 += slab) {
      const int rows = min(slab, n - i0);
      if (!once) {
        __syncthreads();
        stage_w<KT>(ws, w, i0, rows, slab, k, c0);
        __syncthreads();
      }
      const int groups = (rows + G - 1) / G;
      const int iters = (groups + U * W - 1) / (U * W);
      const TS* base = S + (size_t)(i0 + b) * m + j;
      // iteration it takes the groups warp + W·(it·U + u), u < U
      auto load = [&](uint4 (&x)[U], int it) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int g = warp + W * (it * U + u);
          x[u] = stream::load16<VEC>(base + (size_t)G * g * m, j,
                                     G * g + b < rows && it < iters ? m : 0);
        }
      };
      // the vector route issues the next iteration's loads before this
      // one's FMAs, the scalar route (twice the registers in bf16) after
      uint4 cur[U];
      load(cur, 0);
      for (int it = 0; it < iters; ++it) {
        uint4 nxt[U];
        if constexpr (VEC) load(nxt, it + 1);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int g = warp + W * (it * U + u);
          if (g < groups) apply_group<TS, KT>(acc, cur[u], b, ws + G * g * KT);
        }
        if constexpr (VEC) {
#pragma unroll
          for (int u = 0; u < U; ++u) cur[u] = nxt[u];
        } else {
          load(cur, it + 1);
        }
      }
    }
    // the warps' sums of each (column, c) in warp order, then the fused write
#pragma unroll
    for (int h = 0; h < KT; h += Cfg::kRed) {
#pragma unroll
      for (int c = 0; c < Cfg::kRed; ++c)
        *reinterpret_cast<float4*>(red + (warp * Cfg::kRed + c) * Cfg::kRedPitch + 4 * lane) =
            make_float4(acc[0][h + c], acc[1][h + c], acc[2][h + c], acc[3][h + c]);
      __syncthreads();
      for (int e = threadIdx.x; e < kApplyStrip * Cfg::kRed; e += kApplyThreads) {
        const int jj = e / Cfg::kRed, c = e % Cfg::kRed;
        float sum = red[c * Cfg::kRedPitch + jj];
#pragma unroll
        for (int v = 1; v < W; ++v) sum += red[(v * Cfg::kRed + c) * Cfg::kRedPitch + jj];
        const int jc = strip * kApplyStrip + jj, cg = c0 + h + c;
        if (jc < m && cg < k) {
          const size_t o = (size_t)jc * k + cg;
          X[o] = (to_f32(V[o]) - sum) / lam;
        }
      }
      __syncthreads();
    }
  }
}

// per: the consecutive strips of 128 columns a block walks
// (serve_solve.apply_split)
template <typename TS, typename TV, int KT, bool VEC>
cudaError_t launch_apply_kt(const TS* S, const float* w, const TV* V, float* X, int n, int m,
                            int k, float lam, int per, cudaStream_t st) {
  auto kernel = serve_apply_kernel<TS, TV, KT, VEC>;
  const int smem = apply_smem_bytes<KT>(n);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int strips = (m + kApplyStrip - 1) / kApplyStrip;
  const dim3 grid((strips + per - 1) / per, (k + KT - 1) / KT);
  kernel<<<grid, kApplyThreads, smem, st>>>(S, w, V, X, n, m, k, per, lam);
  return stream::counted(cudaGetLastError(),
                         VEC ? stream::kApplyVector : stream::kApplyScalar);
}

template <typename TS, typename TV, bool VEC>
cudaError_t launch_apply_route(const TS* S, const float* w, const TV* V, float* X, int n,
                               int m, int k, float lam, int per, cudaStream_t st) {
  switch (k_tile(k)) {
    case 1: return launch_apply_kt<TS, TV, 1, VEC>(S, w, V, X, n, m, k, lam, per, st);
    case 4: return launch_apply_kt<TS, TV, 4, VEC>(S, w, V, X, n, m, k, lam, per, st);
    case 8: return launch_apply_kt<TS, TV, 8, VEC>(S, w, V, X, n, m, k, lam, per, st);
    default: return launch_apply_kt<TS, TV, 16, VEC>(S, w, V, X, n, m, k, lam, per, st);
  }
}

// vec: the vector route, as serve_solve.stream_route chose it; refused
// (cudaErrorInvalidValue) where a row of S is not 16-byte aligned.
template <typename TS, typename TV>
cudaError_t launch_apply(const TS* S, const float* w, const TV* V, float* X, int n, int m,
                         int k, float lam, int per, int vec, cudaStream_t st) {
  if (per < 1 || ((m + kApplyStrip - 1) / kApplyStrip + per - 1) / per > kApplyMaxBlocks)
    return cudaErrorInvalidValue;
  if (!vec) return launch_apply_route<TS, TV, false>(S, w, V, X, n, m, k, lam, per, st);
  if (m % stream::Lane<TS>::kVec || !stream::aligned16(S)) return cudaErrorInvalidValue;
  return launch_apply_route<TS, TV, true>(S, w, V, X, n, m, k, lam, per, st);
}

}  // namespace repro
