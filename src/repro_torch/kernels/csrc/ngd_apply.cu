// ngd_apply: the second and last pass over S of Algorithm 1,
//
//   x = (v − Sᵀw) / λ        S (n, m) fp32|bf16; w (n,) fp32; v (m,) fp32|bf16
//
// Replaces src/repro/kernels/ngd_apply.py:ngd_apply_pallas. The TPU kernel
// holds an (n, bk) tile of S in VMEM and contracts its sublane axis on the
// MXU. Here one right-hand side has a kernel of its own (the multi-RHS apply
// pass of apply.cuh stays serve_apply's).
//
// Bound: device-memory bytes, n·m·sizeof(S) + m·(sizeof(v) + 4) ≈ 0.123 ms at
// (1024, 100,000) fp32 on an H100 (2 flop per window element, far below the
// fp32 FMA rate). apply.cuh's pass at k = 1 stays at 86 % of it (4-byte
// loads, one column a thread, w re-staged with two barriers every 128
// rows), so:
//
// * Wide loads: a lane reads 16 bytes of a row (4 fp32 or 8 bf16 columns)
//   with ld.global.nc.L1::no_allocate (the window streams past L1), 8 rows
//   at a time: up to 128 KB in flight on an SM. With 8 bytes a lane the bf16
//   window took about as long as the fp32 one: the pass is bound by the
//   requests in flight, not by their bytes. A ragged m or a row not
//   16-byte aligned takes scalar loads.
// * Rows split across warps: the 8 warps of a block read the same strip of
//   columns (128 fp32 or 256 bf16), warp k the rows k, k + 8, …; w is
//   staged in shared memory once (n ≤ 2048; else 2048 rows at a time). The
//   8 partial sums of a column are added in warp order through shared
//   memory, so a repeat is bit-identical.
// * Even load: at most 528 blocks (4 resident on each of an H100's 132 SMs,
//   one wave), each walking the same number of consecutive strips; the
//   split follows from m alone, never from the card.
// * The subtraction and 1/λ are fused into the column's last write.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                 // row streams a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;                // rows in flight a lane
constexpr int kMaxBlocks = 528;
constexpr int kWTile = 2048;              // rows of w staged at a time

// a lane's 16 bytes of a row: kVec columns of the storage type, raw
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  using Bits = uint32_t;
  static constexpr int kVec = 4;
};
template <>
struct Lane<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int kVec = 8;
};

// columns j … j + kVec − 1 of the row at p (p points at column j), raw;
// zero bits past m
template <bool VEC, typename T>
__device__ __forceinline__ uint4 load16(const T* p, int j, int m) {
  using L = Lane<T>;
  uint4 r;
  if (VEC && j + L::kVec - 1 < m) {
    asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }
  typename L::Bits e[L::kVec];
  const typename L::Bits* q = reinterpret_cast<const typename L::Bits*>(p);
#pragma unroll
  for (int c = 0; c < L::kVec; ++c) e[c] = j + c < m ? q[c] : 0;
  memcpy(&r, e, sizeof(r));
  return r;
}

__device__ __forceinline__ void fma16(float (&acc)[4], uint4 r, float w) {
  acc[0] = fmaf(__uint_as_float(r.x), w, acc[0]);
  acc[1] = fmaf(__uint_as_float(r.y), w, acc[1]);
  acc[2] = fmaf(__uint_as_float(r.z), w, acc[2]);
  acc[3] = fmaf(__uint_as_float(r.w), w, acc[3]);
}

// bf16 widened to fp32: the element's bits in the top half of the word
__device__ __forceinline__ void fma16(float (&acc)[8], uint4 r, float w) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] = fmaf(__uint_as_float(u[k] << 16), w, acc[2 * k]);
    acc[2 * k + 1] = fmaf(__uint_as_float(u[k] & 0xffff0000u), w, acc[2 * k + 1]);
  }
}

template <typename TS, typename TV, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
ngd_apply_kernel(const TS* __restrict__ S, const float* __restrict__ w,
                 const TV* __restrict__ v, float* __restrict__ x, int n, int m, int per,
                 float lam) {
  constexpr int kVec = Lane<TS>::kVec;
  constexpr int kCols = 32 * kVec;        // a strip: 128 fp32 or 256 bf16 columns
  __shared__ float ws[kWTile];
  __shared__ __align__(16) float red[kWarps][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strips = (m + kCols - 1) / kCols;
  const int strip_end = min(strips, ((int)blockIdx.x + 1) * per);
  const bool once = n <= kWTile;
  if (once) {
    for (int i = threadIdx.x; i < n; i += kThreads) ws[i] = w[i];
    __syncthreads();
  }
  for (int strip = (int)blockIdx.x * per; strip < strip_end; ++strip) {
    const int j = strip * kCols + kVec * lane;
    float acc[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = 0.f;
    for (int i0 = 0; i0 < n; i0 += kWTile) {
      const int rows = min(kWTile, n - i0);
      if (!once) {
        __syncthreads();
        for (int i = threadIdx.x; i < rows; i += kThreads) ws[i] = w[i0 + i];
        __syncthreads();
      }
      const TS* col = S + (size_t)i0 * m + j;
      int i = warp;
      for (; i + (kUnroll - 1) * kWarps < rows; i += kUnroll * kWarps) {
        uint4 s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          s[u] = load16<VEC>(col + (size_t)(i + u * kWarps) * m, j, m);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fma16(acc, s[u], ws[i + u * kWarps]);
      }
      for (; i < rows; i += kWarps) fma16(acc, load16<VEC>(col + (size_t)i * m, j, m), ws[i]);
    }
#pragma unroll
    for (int c = 0; c < kVec; c += 4)
      *reinterpret_cast<float4*>(&red[warp][kVec * lane + c]) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    __syncthreads();
    for (int c = threadIdx.x; c < kCols; c += kThreads) {
      const int jc = strip * kCols + c;
      float sum = red[0][c];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) sum += red[k][c];
      if (jc < m) x[jc] = (repro::to_f32(v[jc]) - sum) / lam;
    }
    __syncthreads();
  }
}

template <typename TS, typename TV>
int launch(const void* S, const float* w, const void* v, float* x, int n, int m, float lam,
           cudaStream_t st) {
  const TS* s = static_cast<const TS*>(S);
  const TV* vp = static_cast<const TV*>(v);
  constexpr int kVec = Lane<TS>::kVec;
  const int strips = (m + 32 * kVec - 1) / (32 * kVec);
  const int per = (strips + kMaxBlocks - 1) / kMaxBlocks;
  const int blocks = (strips + per - 1) / per;
  // every row of S starts 16-byte aligned for the vector load
  const bool vec = m % kVec == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  if (vec)
    ngd_apply_kernel<TS, TV, true><<<blocks, kThreads, 0, st>>>(s, w, vp, x, n, m, per, lam);
  else
    ngd_apply_kernel<TS, TV, false><<<blocks, kThreads, 0, st>>>(s, w, vp, x, n, m, per, lam);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ngd_apply_launch(const void* S, int s_bf16, const void* w, const void* v,
                                int v_bf16, void* x, int n, int m, float lam, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  float* xp = static_cast<float*>(x);
  using bf16 = __nv_bfloat16;
  if (s_bf16)
    return v_bf16 ? launch<bf16, bf16>(S, wp, v, xp, n, m, lam, st)
                  : launch<bf16, float>(S, wp, v, xp, n, m, lam, st);
  return v_bf16 ? launch<float, bf16>(S, wp, v, xp, n, m, lam, st)
                : launch<float, float>(S, wp, v, xp, n, m, lam, st);
}
