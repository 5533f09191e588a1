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
// Rotation (t, j) reads and writes only column j of L and column t of X, and
// its pair (c, s) depends only on row j: (L[j, j], x[j, :]) after columns
// < j. So row i of the result needs only the pairs of columns j < i, applied
// in order, and the pairs of a panel of 32 columns come from the panel's own
// 32 rows alone.
//
// Bound: the lower triangle read and written once and X read once, 4.3 MB at
// n = 1024 (1.3 µs at 3.35 TB/s), and 6·k flop per lower element, 50 MFLOP
// at k = 16 (under a µs at 67 TFLOP/s fp32). Neither binds: the chain of n
// dependent columns does. Here that chain is n column steps inside one
// warp (no block barrier) plus n/32 hand-offs between warps, and the rest
// of the work is spread over the SMs, in one cooperative launch:
//
//   * rows go in groups of 32, one warp a group (a block is one warp; the
//     grid is the co-resident blocks, group g on block g mod grid, groups
//     in ascending order, so the lowest unfinished group can always run);
//     lane r holds row 32g + r: its entries of X (a chunk of up to 32
//     columns) in registers, its 32 entries of L of one panel and of its
//     diagonal block (fetched first) in shared memory;
//   * trailing step: for each panel p < g, the warp loads the 32 × 32 tile
//     L[32g:, 32p:], stages the panel's pairs from L2 as far as they are
//     published (each a 16-byte {c, flag, s, flag} record whose flags name
//     the chunk that wrote it: no fence on either side) and applies them,
//     each lane its row, column by column as they come, two FMAs a
//     rotation, l ← c·l ± s·x, x ← c·x − s·l; then writes the tile back;
//   * panel step: after the trailing steps of all p < g the warp factors
//     panel g on its own rows: per column, the 32 lanes compute the
//     column's k pairs (warp_rotations: a warp scan of ±b², a reciprocal
//     square root and one Newton step a lane), publish them to device
//     memory as flagged records and apply them to the panel's lower rows,
//     with only warp synchronisation;
//   * lookahead comes from the order: the warp of group g + 1 has applied
//     panels < g, and panel g column by column, while panel g was being
//     factored, so once its last pairs are out it applies them and starts
//     its own.
// The chain is then n × (one column's pairs and one row's k-rotation apply
// in a warp: four dependent warp-wide exchanges, ≈ 850 cycles on an H100)
// plus n/32 × (noticing a panel's last pairs and applying its last
// columns, ≈ 1 µs): ≈ 0.47 ms at n = 1024, where the bound is 1.3 µs
// (tools/triangular_trace.py; PERF.md §6).
//
// Columns of X go in chunks of 32 (a lane a rotation); chunks compose in t
// order, separated by one grid barrier, which also lets the next chunk reuse
// the pair buffer. The kernel reads L in the first chunk and its own output
// after, so it needs no transposes and no scratch copy of L.
//
// Against the TPU kernel (within a few ulps of it on positive definite
// inputs; bit for bit the one-block design's result wherever that design
// chunked X alike, k ≤ 32 for n ≤ 1024 and k ≤ 16 for n ≤ 2048 among them,
// as tools/triangular_ab.py checks):
//  * r_t² = a² ± Σ_{s≤t} b_s² by a warp scan, c = r_{t−1}/r_t and
//    s = b/r_t by a reciprocal square root, and the new diagonal is r,
//    where the TPU carries a_t = (a² ± b²)/r from rotation to rotation and
//    divides each row by r; r² is clamped at 1e-30 after the scan, so a
//    downdate that breaks down gives other values than the TPU's (not
//    necessarily finite);
//  * a rotation whose b is ±0 is skipped, so a zero (or −0.0) column of X
//    is an exact no-op and an all-zero X returns L bit for bit;
//  * a NaN r² stays NaN where fmaxf would clamp it;
//  * the strict upper triangle is exactly 0, as cholupdate.py:57-61 pins
//    it, and x_t[j] is not carried past column j.
// No float atomics, a fixed order and static ownership: repeats are
// bit-identical.
#include "common.cuh"

namespace {

constexpr int kB = 32;           // rows of a group, columns of a panel, lanes of the warp
constexpr int kMaxKC = 32;       // columns of X a chunk (a lane a rotation)
constexpr int kPitch = kB + 1;   // shared tile row pitch: conflict-free rows and columns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// All blocks (one warp each) meet here. sync[0] counts arrivals, sync[1] is
// the generation; both start at 0 for the launch. `generation` is lane 0's.
__device__ void grid_barrier(unsigned* sync, unsigned& generation) {
  __syncwarp();
  if (threadIdx.x == 0) {
    ++generation;
    __threadfence();
    if (atomicAdd(&sync[0], 1u) == gridDim.x - 1) {
      atomicExch(&sync[0], 0u);
      __threadfence();
      st_release(&sync[1], generation);
    } else {
      while (ld_acquire(&sync[1]) < generation) {
      }
    }
    __threadfence();
  }
  __syncwarp();
}

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
// `pairs`, the new diagonal (the last live r, or a) back to `*diag`. The
// scan runs log2(KC) steps: a step of offset ≥ kc changes no lane below kc.
template <int KC, int SIGN>
__device__ __forceinline__ void warp_rotations(const float (&xr)[KC], bool owner, int kc,
                                               float* diag, float eps, float* bsh,
                                               float2* pairs) {
  const int lane = threadIdx.x & 31;
  if (owner) {
#pragma unroll
    for (int t = 0; t < KC; t += 4)
      *reinterpret_cast<float4*>(bsh + t) = make_float4(xr[t], xr[t + 1], xr[t + 2], xr[t + 3]);
  }
  const float a = *diag;
  __syncwarp();
  const float b = lane < kc ? bsh[lane] : 0.f;
  float sq = SIGN * b * b;
#pragma unroll
  for (int off = 1; off < KC; off <<= 1) {
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

// One row's element l = L[i, j] and entries x of X through the kc pairs of
// column j, in t order: l ← c·l ± s·x, x ← c·x − s·l; a pair whose s is ±0
// (and every t ≥ kc) leaves both as they are. All pairs are loaded first and
// the skip is a select, not a branch, so the loads leave the chain of FMAs.
template <int KC, int SIGN>
__device__ __forceinline__ float rotate_row(float v, float (&x)[KC], const float2* pairs,
                                            int kc) {
  float2 cs[KC];
#pragma unroll
  for (int t = 0; t < KC; ++t) cs[t] = pairs[t];
#pragma unroll
  for (int t = 0; t < KC; ++t) {
    const bool live = t < kc && cs[t].y != 0.f;
    const float xt = x[t];
    const float nv = fmaf(cs[t].x, v, SIGN * cs[t].y * xt);
    const float nx = fmaf(cs[t].x, xt, -cs[t].y * v);
    x[t] = live ? nx : xt;
    v = live ? nv : v;
  }
  return v;
}

// A published pair: {c, flag, s, flag}, one 16-byte store, each 8-byte half
// (single-copy atomic) carrying the number of the chunk that wrote it, so a
// reader that sees both flags sees the pair, with no fence on either side.
__device__ __forceinline__ void put_pair(uint4* p, float2 cs, unsigned flag) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(__float_as_uint(cs.x)), "r"(flag), "r"(__float_as_uint(cs.y)), "r"(flag));
}

__device__ __forceinline__ uint4 get_pair(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

struct Shared {
  float tile[kB][kPitch];                   // L[32g + r, 32p + c]: lane r's row
  float diag[kB][kPitch];                   // the group's diagonal block
  __align__(16) float2 pairs[kB * kMaxKC];  // a panel's pairs, by column j then t
  __align__(16) float2 rot[kMaxKC];         // the column being factored
  __align__(16) float bsh[kMaxKC];          // its owner's entries of X
};

// Stage panel columns [done, 32) of the published pairs `from` (entry
// j·KC + t) into `to`, as far as they are published for this chunk; returns
// the first column with a pair missing (32 when the panel is complete), the
// same in every lane. Lane `lane` reads t = lane mod KC of every (32/KC)-th
// column, eight loads in flight before any is looked at.
template <int KC>
__device__ __forceinline__ int stage_pairs(const uint4* from, float2* to, int done, int kc,
                                           unsigned flag) {
  constexpr int kStep = 32 / KC;            // columns a round of 32 lanes covers
  const int lane = threadIdx.x, t = lane % KC;
  int missing = kB;
  for (int j0 = done + lane / KC; j0 < kB; j0 += 8 * kStep) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * kStep;
      v[u] = (j < kB && t < kc) ? get_pair(from + j * KC + t) : make_uint4(0u, flag, 0u, flag);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * kStep;
      if (j >= kB) break;
      if (v[u].y == flag && v[u].w == flag)
        to[j * KC + t] = make_float2(__uint_as_float(v[u].x), __uint_as_float(v[u].z));
      else
        missing = min(missing, j);
    }
  }
  return __reduce_min_sync(kFull, missing);
}

// The sweep. L (input, read in the first chunk) and Lp (output) are
// row-major; pairs holds ⌈n/32⌉·32·KC published pairs (entry (32p + j)·KC +
// t: panel p, column j, rotation t); sync[0..1] is the grid barrier. All
// zero at launch.
template <int KC, int SIGN>
__global__ void __launch_bounds__(kB)
cholupdate_kernel(const float* __restrict__ L, const float* __restrict__ X, float* Lp,
                  uint4* pairs, unsigned* sync, int n, int k, float eps) {
  __shared__ Shared sh;
  const int lane = threadIdx.x;
  const int groups = (n + kB - 1) / kB;
  unsigned generation = 0;
  for (int c0 = 0, chunk = 1; c0 < k; c0 += KC, ++chunk) {
    const int kc = min(KC, k - c0);
    const unsigned flag = static_cast<unsigned>(chunk);
    const float* src = c0 == 0 ? L : Lp;
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      const int r0 = g * kB, i = r0 + lane;
      const int rows = min(kB, n - r0);
      float x[KC];
#pragma unroll
      for (int t = 0; t < KC; ++t)
        x[t] = (i < n && t < kc) ? X[static_cast<size_t>(i) * k + c0 + t] : 0.f;
      // the diagonal block, fetched now: the panel step starts without a wait
      for (int rr = 0; rr < kB; ++rr)
        sh.diag[rr][lane] = (rr < rows && lane <= rr)
                                ? __ldcg(src + static_cast<size_t>(r0 + rr) * n + r0 + lane)
                                : 0.f;
      // trailing steps: panels p < g, in order, each column as soon as its
      // pairs are out (a panel long finished is staged whole)
      for (int p = 0; p < g; ++p) {
        const int q0 = p * kB;
        for (int rr = 0; rr < kB; ++rr)
          sh.tile[rr][lane] = rr < rows ? __ldcg(src + static_cast<size_t>(r0 + rr) * n + q0 + lane)
                                        : 0.f;
        float* row = sh.tile[lane];
        const uint4* from = pairs + static_cast<size_t>(q0) * KC;
        for (int done = 0; done < kB;) {
          const int ready = stage_pairs<KC>(from, sh.pairs, done, kc, flag);
          if (ready == done) __nanosleep(32);   // nothing new: back off a little
          __syncwarp();
#pragma unroll 2
          for (int j = done; j < ready; ++j)
            row[j] = rotate_row<KC, SIGN>(row[j], x, sh.pairs + j * KC, kc);
          __syncwarp();
          done = ready;
        }
        for (int rr = 0; rr < rows; ++rr)
          Lp[static_cast<size_t>(r0 + rr) * n + q0 + lane] = sh.tile[rr][lane];
        __syncwarp();
      }
      // panel step: factor the diagonal block on the group's own rows,
      // publishing each column's pairs as they come
      __syncwarp();
      uint4* out = pairs + static_cast<size_t>(r0) * KC;
      for (int j = 0; j < rows; ++j) {
        warp_rotations<KC, SIGN>(x, lane == j, kc, &sh.diag[j][j], eps, sh.bsh, sh.rot);
        if (lane < kc) put_pair(out + j * KC + lane, sh.rot[lane], flag);
        if (lane > j) sh.diag[lane][j] = rotate_row<KC, SIGN>(sh.diag[lane][j], x, sh.rot, kc);
        __syncwarp();
      }
      for (int rr = 0; rr < rows; ++rr)
        if (r0 + lane < n)
          Lp[static_cast<size_t>(r0 + rr) * n + r0 + lane] = lane <= rr ? sh.diag[rr][lane] : 0.f;
      if (c0 == 0) {   // off the chain: the strict upper triangle right of the block
        for (int rr = 0; rr < rows; ++rr)
          for (int c = r0 + kB + lane; c < n; c += kB)
            Lp[static_cast<size_t>(r0 + rr) * n + c] = 0.f;
      }
    }
    // every reader of this chunk's pairs is done before the next overwrites them
    if (c0 + KC < k) grid_barrier(sync, generation);
  }
}

template <int KC, int SIGN>
cudaError_t sweep(const float* L, const float* X, float* Lp, uint4* pairs, unsigned* sync,
                  int n, int k, cudaStream_t st) {
  const auto kernel = cholupdate_kernel<KC, SIGN>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kB, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int groups = (n + kB - 1) / kB;
  const int grid = groups < sms * per_sm ? groups : sms * per_sm;
  float eps = 1e-30f;
  void* args[] = {&L, &X, &Lp, &pairs, &sync, &n, &k, &eps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, kB, args, 0,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KC>
cudaError_t sweep_signed(const float* L, const float* X, float* Lp, uint4* pairs,
                         unsigned* sync, int n, int k, int sign, cudaStream_t st) {
  return sign > 0 ? sweep<KC, 1>(L, X, Lp, pairs, sync, n, k, st)
                  : sweep<KC, -1>(L, X, Lp, pairs, sync, n, k, st);
}

}  // namespace

// The scratch of a call: one 16-byte record for the grid barrier, then
// 32·⌈n/32⌉·KC published pairs, KC = 8, 16 or 32 columns of X a chunk (the
// least that holds k, 32 beyond).
static size_t work_records(int n, int k) {
  const int kc = k <= 8 ? 8 : k <= 16 ? 16 : kMaxKC;
  return 1 + static_cast<size_t>((n + kB - 1) / kB) * kB * kc;
}

// L (n, n) row-major in, Lp (n, n) row-major out (every element written, the
// strict upper triangle 0); work: work_records(n, k) 16-byte records of
// scratch, zeroed here. One memset and one cooperative launch on `stream`.
extern "C" int cholupdate_launch(const void* L, const void* X, void* Lp, void* work, int n,
                                 int k, int sign, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 * 1024 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(work, 0, work_records(n, k) * sizeof(uint4), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* l = static_cast<const float*>(L);
  const float* x = static_cast<const float*>(X);
  float* lp = static_cast<float*>(Lp);
  unsigned* s = static_cast<unsigned*>(work);
  uint4* pr = static_cast<uint4*>(work) + 1;
  if (k <= 8) err = sweep_signed<8>(l, x, lp, pr, s, n, k, sign, st);
  else if (k <= 16) err = sweep_signed<16>(l, x, lp, pr, s, n, k, sign, st);
  else err = sweep_signed<kMaxKC>(l, x, lp, pr, s, n, k, sign, st);
  return static_cast<int>(err);
}
