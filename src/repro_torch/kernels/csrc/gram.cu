// gram / gram_acc / gram_sv: the tall-skinny Gram of Algorithm 1,
//
//   W = [W_in +] S·Sᵀ          (n, n) fp32, S (n, m) fp32|bf16 row-major, m ≫ n
//   u = S·v                    (n,) fp32, optional, from the same pass over S
//
// Replaces src/repro/kernels/gram.py:gram_pallas (zero-seeded),
// gram.py:gram_acc_pallas (seeded from the aliased W_in, the per-block chain
// of ops.gram_blocks) and gram_sv.py:gram_sv_pallas (W and u in one pass).
// On the TPU each (128, 128) output tile sits in VMEM while a sequential grid
// axis walks all of m on one core. Here blocks run in parallel in no order,
// and at n = 256 there are only 3 lower tiles of 128, so:
//
//   1. gram_partial_kernel: one block per (lower tile, chunk of m). The tile
//      is a 128×128 fp32 FMA product on the CUDA cores, both operands staged
//      through shared memory in double-buffered stages of 16 columns (bf16
//      is widened on load), each thread holding an 8×8 sub-tile in
//      registers. Only tiles on or below the diagonal are computed; a
//      diagonal tile reads one staged operand for both sides. Each block
//      writes its tile's partial sum to scratch (P, tiles, 128, 128).
//   2. gram_reduce_kernel: sums the P partials of each element in a fixed
//      order (p ascending), adds W_in, writes W[i, j] and mirrors W[j, i].
//      No float atomics, and the split of m depends on the shape only, so a
//      repeated call is bit-identical.
//
// u accumulates on diagonal tiles only (each row band counts once; the TPU
// kernel gates on j == 0 instead), from the staged tile and a staged slice
// of v, which arrives in S's storage dtype: the wrapper rounds v to it, as
// gram_sv_pallas does (gram_sv.py:86).
//
// Bound: fp32 operations, not bytes. The lower triangle at (1024, 100,000)
// is ≈ 1.05·10¹¹ flop, ≈ 1.6 ms at the H100's 67 TFLOP/s fp32; the window
// is read in ≈ 0.12 ms. Ragged n and m are masked at the edges (zeros are
// staged), so S is never padded or copied.
#include "common.cuh"

namespace {

constexpr int kT = 128;        // output tile edge; mirrored in kernels/gram.py
constexpr int kK = 16;         // columns of m per stage; mirrored in kernels/gram.py
constexpr int kThreads = 256;  // 16 × 16 threads, 8 × 8 outputs each
constexpr int kLd = kT + 4;    // staged row stride: keeps the float4 reads aligned

// Lower-triangle tile t (row-major over bi ≥ bj) → (bi, bj).
__device__ __forceinline__ void lower_tile(int t, int& bi, int& bj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  bi = i;
  bj = t - i * (i + 1) / 2;
}

// Row (or column) of a thread's i-th output within the tile: two bands of 4,
// 64 apart, so a warp's float4 reads of a staged stage hit distinct banks.
__device__ __forceinline__ int sub(int t, int i) { return (i < 4 ? 0 : 64) + t * 4 + (i & 3); }

// Two blocks per SM (128 registers a thread, a few spilled): the second
// block's loads hide the first's latency (PERF.md §6).
template <typename T, bool SV>
__global__ void __launch_bounds__(kThreads, 2)
gram_partial_kernel(const T* __restrict__ S, const T* __restrict__ v, int n, int m,
                    int chunk, float* __restrict__ part, float* __restrict__ part_u,
                    int u_stride) {
  __shared__ __align__(16) float As[2][kK][kLd];
  __shared__ __align__(16) float Bs[2][kK][kLd];
  __shared__ float vs[2][kK];
  int bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const bool diag = bi == bj;
  const int p = blockIdx.y;
  const int j_begin = p * chunk;
  const int j_end = min(m, j_begin + chunk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // loader: element q of this thread is row lr + 16q, column lk of the stage;
  // a warp reads two rows of 16 neighbouring columns
  const int lk = tid & 15, lr = tid >> 4;
  const bool u_thread = SV && diag && tx == 0;

  float ra[8], rb[8], rv = 0.f;
  auto load = [&](int j0) {
    const int j = j0 + lk;
    const bool jin = j < j_end;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int ia = bi * kT + lr + 16 * q;
      ra[q] = (jin && ia < n) ? repro::to_f32(S[(size_t)ia * m + j]) : 0.f;
      const int ib = bj * kT + lr + 16 * q;
      rb[q] = (!diag && jin && ib < n) ? repro::to_f32(S[(size_t)ib * m + j]) : 0.f;
    }
    if (SV && diag && tid < kK) rv = (j0 + tid < j_end) ? repro::to_f32(v[j0 + tid]) : 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      As[buf][lk][lr + 16 * q] = ra[q];
      if (!diag) Bs[buf][lk][lr + 16 * q] = rb[q];
    }
    if (SV && diag && tid < kK) vs[buf][tid] = rv;
  };

  float acc[8][8];
  float uacc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int stages = (j_end - j_begin + kK - 1) / kK;
  load(j_begin);
  store(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) load(j_begin + (s + 1) * kK);   // next stage's loads in flight
    const float(*A)[kLd] = As[buf];
    const float(*B)[kLd] = diag ? As[buf] : Bs[buf];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&A[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&A[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&B[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&B[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (u_thread) {
        const float vk = vs[buf][kk];
#pragma unroll
        for (int i = 0; i < 8; ++i) uacc[i] = fmaf(a[i], vk, uacc[i]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < stages) store(buf ^ 1);
    __syncthreads();
  }

  float* out = part + ((size_t)p * gridDim.x + blockIdx.x) * kT * kT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (size_t)sub(ty, i) * kT;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (u_thread) {
#pragma unroll
    for (int i = 0; i < 8; ++i) part_u[(size_t)p * u_stride + bi * kT + sub(ty, i)] = uacc[i];
  }
}

// W[i, j] = W_in[i, j] + Σ_p part[p, tile, r, c] (p ascending), mirrored;
// u[i] = Σ_p part_u[p, i]. W_in may alias W: each thread reads and writes
// only its own pair (i, j), (j, i).
__global__ void gram_reduce_kernel(const float* __restrict__ part, int P, int tiles, int n,
                                   const float* W_in, float* W,
                                   const float* __restrict__ part_u, int u_stride,
                                   float* __restrict__ u) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t tile_elems = (size_t)kT * kT;
  if (e < (size_t)tiles * tile_elems) {
    const int t = (int)(e / tile_elems);
    const int rc = (int)(e % tile_elems);
    const int r = rc / kT, c = rc % kT;
    int bi, bj;
    lower_tile(t, bi, bj);
    const int i = bi * kT + r, j = bj * kT + c;
    if (i < n && j < n && (bi != bj || r >= c)) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += part[((size_t)p * tiles + t) * tile_elems + rc];
      const size_t ij = (size_t)i * n + j, ji = (size_t)j * n + i;
      const float lo = W_in ? W_in[ij] + s : s;
      const float hi = W_in ? W_in[ji] + s : s;
      W[ij] = lo;
      if (i != j) W[ji] = hi;
    }
  }
  if (u != nullptr && e < (size_t)n) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part_u[(size_t)p * u_stride + e];
    u[e] = s;
  }
}

template <typename T>
int gram_impl(const void* S, const void* v, const float* W_in, float* W, float* u,
              float* part, float* part_u, int n, int m, int tiles, int P, int chunk,
              cudaStream_t st) {
  const T* s = static_cast<const T*>(S);
  const int u_stride = ((n + kT - 1) / kT) * kT;
  const dim3 grid(tiles, P);
  if (v != nullptr)
    gram_partial_kernel<T, true><<<grid, kThreads, 0, st>>>(
        s, static_cast<const T*>(v), n, m, chunk, part, part_u, u_stride);
  else
    gram_partial_kernel<T, false><<<grid, kThreads, 0, st>>>(s, nullptr, n, m, chunk, part,
                                                             nullptr, u_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = (size_t)tiles * kT * kT;
  gram_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      part, P, tiles, n, W_in, W, v != nullptr ? part_u : nullptr, u_stride, u);
  return cudaGetLastError();
}

}  // namespace

// S (n, m) fp32|bf16; v (m,) in S's dtype or null; W_in (n, n) fp32 or null,
// may equal W; W (n, n) fp32; u (n,) fp32 or null; part (P, tiles, 128, 128)
// and part_u (P, ceil(n/128)·128) fp32 scratch. tiles = T(T+1)/2 for
// T = ceil(n/128); chunk is a multiple of 16 and P·chunk ≥ m.
extern "C" int gram_launch(const void* S, int bf16, const void* v, const void* W_in, void* W,
                           void* u, void* part, void* part_u, int n, int m, int tiles, int P,
                           int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wi = static_cast<const float*>(W_in);
  float* w = static_cast<float*>(W);
  float* up = static_cast<float*>(u);
  float* pp = static_cast<float*>(part);
  float* pu = static_cast<float*>(part_u);
  return bf16 ? gram_impl<__nv_bfloat16>(S, v, wi, w, up, pp, pu, n, m, tiles, P, chunk, st)
              : gram_impl<float>(S, v, wi, w, up, pp, pu, n, m, tiles, P, chunk, st);
}
