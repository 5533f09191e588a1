// cholupdate: the rank-k factor update and downdate,
//
//   L' with L'·L'ᵀ = L·Lᵀ + sign·X·Xᵀ      L (n, n) lower fp32, X (n, k) fp32,
//                                          sign = ±1; n ≤ 32768, any k
//
// Replaces src/repro/kernels/cholupdate.py:cholupdate_pallas, which holds L
// and X in VMEM and runs, for each update column t and each factor column j,
// one plane rotation (circular for +, hyperbolic for −) of (L[:, j], x_t):
//
//     r = √max(a² ± b², 1e-30),  a = L[j, j], b = x_t[j]
//     L[:, j] ← (a·L[:, j] ± b·x_t)/r,   x_t ← (a·x_t − b·L[:, j])/r
//
// Rotation (t, j) reads and writes only column j of L and column t of X. So
// the loop order j outer, t inner gives every element the same sequence of
// rotations as the TPU's t-outer loop, and row i of the result needs only
// the rotations of columns j < i, in order. The sweep is one launch of one
// block, between two tiled transposes (three launches on one stream): it
// runs on a column-major copy of L, where a column is contiguous and the
// 32 rows of a warp are one 128-byte line (row-major, they would be 32
// lines n floats apart, falling into few L1 sets).
//
//   * thread tid owns rows tid, tid + T, ... (T ≤ 1024 threads, R rows a
//     thread) and keeps their entries of X in registers, KC = 32/R columns
//     of X at a time (k > KC runs the sweep again per chunk; exact, since
//     the chunks' rotations compose in t order);
//   * the k rotations (c, s) of column j sit in shared memory; every row
//     i > j applies them to its L[i, j] and its X entries,
//         l ← c·l ± s·x,   x ← c·x − s·l;
//   * meanwhile the warp that holds row j + 1, whose X entries are final
//     for that column once it has applied column j, computes column
//     j + 1's rotations (lane t takes rotation t) into the other of two
//     buffers; one barrier, next column.
//
// Bound: the lower triangle read and written once and X read once, 4.3 MB
// at n = 1024 (1.3 µs at 3.35 TB/s; the two transposes move 16 MB more,
// about 5 µs), and 6·k flop per lower element, 50 MFLOP at k = 16 (under
// a µs at 67 TFLOP/s fp32). Neither binds: the n-long chain of dependent
// columns on one SM does — per column a barrier, the
// rotations and the applies of every row below it. The design shortens
// each link: a column's rotations are one warp scan of ±b_t² and one
// reciprocal square root a lane, not a chain over t; they overlap the
// other warps' applies (the lookahead); and each column's loads of
// L[i, j] are issued a barrier before they are used. A multi-block
// wavefront is the next design.
//
// Against the TPU kernel (within a few ulps of it on positive definite
// inputs):
//  * r_t² = a² ± Σ_{s≤t} b_s² by a warp scan, c = r_{t−1}/r_t and
//    s = b/r_t by a reciprocal square root, and the new diagonal is r,
//    where the TPU carries a_t = (a² ± b²)/r from rotation to rotation and
//    divides each row by r; r² is clamped at 1e-30 after the scan, so a
//    downdate that breaks down gives other finite garbage than the TPU's;
//  * a rotation whose b is ±0 is skipped, so a zero (or −0.0) column of X
//    is an exact no-op and an all-zero X returns L bit for bit;
//  * a NaN r² stays NaN where fmaxf would clamp it;
//  * the strict upper triangle is exactly 0 (written so by the transpose
//    back), as cholupdate.py:57-61 pins it, and x_t[j] is not carried past
//    column j.
// No atomics and a fixed order: repeats are bit-identical.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;   // mirrored as MAX_THREADS in kernels/cholupdate.py

constexpr unsigned kFull = 0xffffffffu;

// The rotations of factor column j, computed by the 32 lanes of the warp
// that holds row j, lane t taking rotation t of the chunk: with a = L[j, j]
// and b_t the owner lane's entries of X (after columns < j),
//
//   r_t² = a² ± Σ_{s≤t} b_s²   (a warp scan; clamped at eps, NaN stays NaN)
//   c_t = r_prev / r_t,  s_t = b_t / r_t,   r_prev the r of the last live
//                                           rotation before t, or a,
//
// 1/r_t from rsqrtf and one Newton step, r_t = r_t²·(1/r_t), each within an
// ulp or two. A b of ±0 gives the no-op pair (1, 0). The pairs go to
// `pairs`, the new diagonal (the last live r, or a) back to `*diag`.
// Nothing here is a chain over t: one scan, then every lane at once.
template <int KC, int SIGN>
__device__ __forceinline__ void warp_rotations(const float (&xr)[KC], bool owner, int kc,
                                               float* diag, float eps, float* bsh,
                                               float2* pairs) {
  const int lane = threadIdx.x & 31;
  if (owner) {
#pragma unroll
    for (int t = 0; t < KC; ++t)
      if (t < kc) bsh[t] = xr[t];
  }
  const float a = *diag;
  __syncwarp();
  const float b = lane < kc ? bsh[lane] : 0.f;
  float sq = SIGN * b * b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, sq, off);
    if (lane >= off) sq += y;
  }
  float p = fmaf(a, a, sq);
  p = isnan(p) ? p : fmaxf(p, eps);
  float y = rsqrtf(p);
  y = y * fmaf(-0.5f * p * y, y, 1.5f);
  const float r = p * y;
  const bool live = b != 0.f;
  const unsigned lives = __ballot_sync(kFull, live);
  const unsigned before = lives & ((1u << lane) - 1u);
  const float r_before = __shfl_sync(kFull, r, before ? 31 - __clz(before) : lane);
  const float r_last = __shfl_sync(kFull, r, lives ? 31 - __clz(lives) : 0);
  if (lane < kc)
    pairs[lane] = live ? make_float2((before ? r_before : a) * y, b * y)
                       : make_float2(1.f, 0.f);
  if (owner) *diag = lives ? r_last : a;
  __syncwarp();
}

// The rotations of column c into rot[c & 1], by the warp that holds row c
// (thread c % T, its row slot c / T); the other warps return at once. Lt is
// the factor in column-major order (element (i, j) at j·n + i).
template <int R, int KC, int SIGN>
__device__ __forceinline__ void rotate(int c, const float (&x)[R][KC], float* Lt, int n,
                                       int kc, float eps, float* bsh, float2 (*rot)[KC]) {
  // R > 1 only when n > kThreads, and then T = kThreads: a shift, not a
  // runtime division
  const int tc = R == 1 ? c : c % kThreads;
  const int qc = R == 1 ? 0 : c / kThreads;
  if (tc >> 5 != threadIdx.x >> 5) return;
  float* d = Lt + static_cast<size_t>(c) * n + c;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (q == qc)
      warp_rotations<KC, SIGN>(x[q], tc == static_cast<int>(threadIdx.x), kc, d, eps, bsh,
                               rot[c & 1]);
}

constexpr int kAhead = 4;   // columns of L prefetched into L1 ahead of use

__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The sweep, in place on Lt, the factor in column-major order: a column of
// L is contiguous there, so a warp's loads and stores of L[i, j] for its 32
// rows are one 128-byte line each (row-major, they are 32 lines n floats
// apart, which also fall into few L1 sets).
template <int R, int SIGN>
__global__ void __launch_bounds__(kThreads)
cholupdate_kernel(float* Lt, const float* __restrict__ X, int n, int k, float eps) {
  constexpr int KC = 32 / R;
  __shared__ float2 rot[2][KC];
  __shared__ float bsh[KC];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    float x[R][KC];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = tid + q * T;
#pragma unroll
      for (int t = 0; t < KC; ++t)
        x[q][t] = (i < n && t < kc) ? X[static_cast<size_t>(i) * k + c0 + t] : 0.f;
    }
    rotate<R, KC, SIGN>(0, x, Lt, n, kc, eps, bsh, rot);
    float l[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = tid + q * T;
      l[q] = (i > 0 && i < n) ? Lt[i] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      // apply column j's rotations (in rot[j & 1]) to my rows below it
      const float2* pairs = rot[j & 1];
      float* col = Lt + static_cast<size_t>(j) * n;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = tid + q * T;
        if (i <= j || i >= n) continue;
        float v = l[q];
#pragma unroll
        for (int t = 0; t < KC; ++t) {
          if (t >= kc) break;
          const float2 cs = pairs[t];
          if (cs.y == 0.f) continue;
          const float xt = x[q][t];
          const float nv = fmaf(cs.x, v, SIGN * cs.y * xt);
          x[q][t] = fmaf(cs.x, xt, -cs.y * v);
          v = nv;
        }
        col[i] = v;
      }
      // look ahead: the warp of row j + 1, whose entries of X are now final
      // for column j + 1, computes that column's rotations into the other
      // buffer while the other warps apply column j
      if (j + 1 < n) rotate<R, KC, SIGN>(j + 1, x, Lt, n, kc, eps, bsh, rot);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = tid + q * T;
        l[q] = (i > j + 1 && i < n) ? col[n + i] : 0.f;
        if (i > j + kAhead && i < n && j + kAhead < n) prefetch_l1(col + kAhead * n + i);
      }
      __syncthreads();
    }
  }
}

// dst[r·n + c] = src[c·n + r] (0 above the diagonal with zero_upper), by
// 32 × 32 tiles staged in shared memory: both sides coalesced.
__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ src, float* __restrict__ dst, int n,
                 int zero_upper) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int y = threadIdx.y; y < 32; y += 8) {
    const int c = c0 + y, r = r0 + threadIdx.x;
    if (c < n && r < n) tile[y][threadIdx.x] = src[static_cast<size_t>(c) * n + r];
  }
  __syncthreads();
  for (int y = threadIdx.y; y < 32; y += 8) {
    const int r = r0 + y, c = c0 + threadIdx.x;
    if (r < n && c < n)
      dst[static_cast<size_t>(r) * n + c] =
          zero_upper && c > r ? 0.f : tile[threadIdx.x][y];
  }
}

template <int R>
cudaError_t sweep(float* Lt, const float* X, int n, int k, int sign, int threads,
                  cudaStream_t st) {
  if (sign > 0)
    cholupdate_kernel<R, 1><<<1, threads, 0, st>>>(Lt, X, n, k, 1e-30f);
  else
    cholupdate_kernel<R, -1><<<1, threads, 0, st>>>(Lt, X, n, k, 1e-30f);
  return cudaGetLastError();
}

}  // namespace

// Rows per thread, a power of two up to 32, for n rows on `threads`
// threads; 0 when n is beyond 32·1024.
static int rows_per_thread(int n, int threads) {
  const int need = (n + threads - 1) / threads;
  for (int r = 1; r <= 32; r *= 2)
    if (r >= need) return r;
  return 0;
}

// L (n, n) row-major in, Lp (n, n) row-major out, work (n, n) scratch for
// the column-major copy the sweep runs on: transpose in, sweep, transpose
// out with the strict upper triangle written as 0. Three launches on one
// stream.
extern "C" int cholupdate_launch(const void* L, const void* X, void* work, void* Lp, int n,
                                 int k, int sign, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = n >= kThreads ? kThreads : ((n + 31) / 32) * 32;
  const int R = rows_per_thread(n, threads);
  if (n < 1 || k < 1 || R == 0) return static_cast<int>(cudaErrorInvalidValue);
  float* Lt = static_cast<float*>(work);
  const float* xp = static_cast<const float*>(X);
  const dim3 tiles((n + 31) / 32, (n + 31) / 32), tile_threads(32, 8);
  transpose_kernel<<<tiles, tile_threads, 0, st>>>(static_cast<const float*>(L), Lt, n, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (R) {
    case 1: err = sweep<1>(Lt, xp, n, k, sign, threads, st); break;
    case 2: err = sweep<2>(Lt, xp, n, k, sign, threads, st); break;
    case 4: err = sweep<4>(Lt, xp, n, k, sign, threads, st); break;
    case 8: err = sweep<8>(Lt, xp, n, k, sign, threads, st); break;
    case 16: err = sweep<16>(Lt, xp, n, k, sign, threads, st); break;
    default: err = sweep<32>(Lt, xp, n, k, sign, threads, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  transpose_kernel<<<tiles, tile_threads, 0, st>>>(Lt, static_cast<float*>(Lp), n, 1);
  return static_cast<int>(cudaGetLastError());
}
