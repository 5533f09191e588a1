// cholesky: L = chol(W), lower triangular, W (n, n) fp32 symmetric positive
// definite (its lower triangle is read), any n. (The reference caps its
// kernel at n = 1024, the size its VMEM holds, and gives XLA the rest;
// nothing here needs that cap.)
//
// Replaces src/repro/kernels/cholesky.py:cholesky_pallas, a left-looking
// panel factorization (panels of 16) inside one kernel invocation, with W,
// L and the panel in VMEM (16 MB). On the H100 an n = 1024 fp32 W is 4 MB:
// it fits no block's 227 KB of shared memory, so the matrix stays in device
// memory (the 50 MB L2 holds it) and the work is spread over the SMs.
//
// Bound: n³/3 flop (≈ 3.6·10⁸ at n = 1024, 5 µs at 67 TFLOP/s fp32) and
// 8n² bytes. The previous design made one dependent launch per panel of 16
// (64 at n = 1024, ≈ 13.6 µs each), each ending in a last-block counter and
// a second pass over partials: latency, not arithmetic, bounded it. Here it
// is ONE cooperative launch (every block co-resident; the launch refuses
// rather than deadlocks) walking panels of 64, a right-looking blocked
// schedule over 64 × 64 tiles:
//
// * Every lower tile (I, J) has a fixed owner block (tiles numbered down
//   the columns, owner = number mod grid). Step 0 copies W's lower tiles
//   into L (zeroing the upper ones); step c ≥ 1 subtracts panel c − 1
//   from the tiles of columns J ≥ c: A_IJ −= L_I,c−1 · L_J,c−1ᵀ, fp32 FMAs,
//   the panel's 64 terms in ascending order.
// * Lookahead: the owner of the diagonal tile (c, c) updates it first,
//   factors it in shared memory and publishes L_cc (and its reciprocal
//   pivots) with a flag, while the other blocks update their tiles of
//   panel c.
// * Panel solve: the owner of each (I, c), I > c, after its other updates,
//   waits for the flag and solves its 64 rows against L_cc.
// * Both triangular steps go left-looking over blocks of 16 columns in
//   shared memory: the block subtracts the finished columns (kept also
//   transposed, so a term is one broadcast load and one float4), a warp
//   factors its 16 × 16 diagonal block (every lane the whole block in
//   registers: on a chain of 16 dependent pivots a shuffle costs more
//   than the arithmetic it would save), and a thread a row solves the rest
//   against it — four barriers a block of 16, not one a column.
// * A grid barrier (an integer generation counter, release/acquire) ends
//   each step; T = ⌈n/64⌉ steps, T − 1 barriers (15 at n = 1024).
//
// Column j of a diagonal tile takes the pivot d = p·rsqrt(p), p =
// max(a_jj, 1e-30) (a NaN pivot stays NaN), as cholesky.py:63 clamps, and
// scales the entries below it by rsqrt(p) (within two ulps of the TPU
// kernel's sqrt and division): a W that is not positive definite gives
// finite garbage where the plain version (torch.linalg.cholesky, like
// jnp.linalg.cholesky) gives NaN; the two agree on SPD inputs only. A
// ragged last tile (n % 64) is padded with the identity in shared memory,
// which gives the same L as the reference's identity padding. No float
// atomics, a fixed summation order and static ownership: repeats are
// bit-identical.
#include "common.cuh"

namespace {

constexpr int kT = 64;            // tile (panel) size; mirrored in kernels/cholesky.py
constexpr int kThreads = 256;
constexpr int kLd = kT + 4;       // shared row stride (float4-aligned)

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// All blocks of the grid meet here. sync[0] counts arrivals, sync[1] is the
// generation; both start at 0 for the launch.
__device__ void grid_barrier(unsigned* sync, unsigned& generation) {
  __syncthreads();
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
  __syncthreads();
}

struct Shared {
  float a[kT][kLd];   // a tile, row-major: an operand, the diagonal tile, the rows being solved
  float b[kT][kLd];   // the second operand; or the finished columns, transposed
  float d[kT];        // the diagonal tile's pivots
  float rd[kT];       // and their reciprocal square roots
};

// first tile index ≥ lo that this block owns
__device__ __forceinline__ int first_owned(int lo) {
  const int G = gridDim.x;
  return lo + ((static_cast<int>(blockIdx.x) - lo % G) % G + G) % G;
}

// index of the first tile of column J (tiles numbered down the columns)
__device__ __forceinline__ int col_start(int J, int T) { return J * T - J * (J - 1) / 2; }

__device__ __forceinline__ void tile_of(int idx, int T, int& I, int& J) {
  J = 0;
  int start = 0;
  while (idx >= start + (T - J)) {
    start += T - J;
    ++J;
  }
  I = J + idx - start;
}

// step 0: the lower tile (I, J) of W into L; the mirrored upper tile (or the
// diagonal tile's upper part) zero
__device__ void copy_tile(const float* __restrict__ W, float* L, int n, int I, int J) {
#pragma unroll 16
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int i = e / kT, q = e % kT, r = I * kT + i, c = J * kT + q;
    if (r < n && c < n) L[(size_t)r * n + c] = (I > J || q <= i) ? W[(size_t)r * n + c] : 0.f;
    if (I > J) {   // (J, I): row J·64 + i, column I·64 + q
      const int r2 = J * kT + i, c2 = I * kT + q;
      if (c2 < n) L[(size_t)r2 * n + c2] = 0.f;
    }
  }
}

// dst = the 64 × 64 tile of L at (r0, c0), rows at or past n zero; the
// columns are those of a full panel (c0 + 64 ≤ n)
__device__ __forceinline__ void load_tile(float (*dst)[kLd], const float* L, int n, int r0,
                                          int c0) {
  const int tid = threadIdx.x;
  if ((n & 3) == 0) {   // 16-byte rows: a float4 a thread a step
#pragma unroll
    for (int u = 0; u < kT * kT / 4 / kThreads; ++u) {
      const int e = tid + kThreads * u, i = e / 16, k = 4 * (e % 16);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + i < n) v = __ldcg(reinterpret_cast<const float4*>(L + (size_t)(r0 + i) * n + c0 + k));
      *reinterpret_cast<float4*>(&dst[i][k]) = v;
    }
  } else {
#pragma unroll 16
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, k = e % kT;
      dst[i][k] = r0 + i < n ? __ldcg(L + (size_t)(r0 + i) * n + c0 + k) : 0.f;
    }
  }
}

// dst[k][i] = L[r0 + i][c0 + k]: the tile at (r0, c0) transposed (a full
// tile: r0 + 64 ≤ n and c0 + 64 ≤ n)
__device__ __forceinline__ void load_tile_t(float (*dst)[kLd], const float* L, int n, int r0,
                                            int c0) {
  const int tid = threadIdx.x;
  if ((n & 3) == 0) {
#pragma unroll
    for (int u = 0; u < kT * kT / 4 / kThreads; ++u) {
      const int e = tid + kThreads * u, i = e / 16, k = 4 * (e % 16);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(L + (size_t)(r0 + i) * n + c0 + k));
      dst[k][i] = v.x;
      dst[k + 1][i] = v.y;
      dst[k + 2][i] = v.z;
      dst[k + 3][i] = v.w;
    }
  } else {
#pragma unroll 16
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, k = e % kT;
      dst[k][i] = __ldcg(L + (size_t)(r0 + i) * n + c0 + k);
    }
  }
}

// A_IJ −= L_Ic · L_Jcᵀ over the 64 columns of panel c (c < T − 1: a full
// panel), each entry's 64 terms in ascending order. Thread (ty, tx) owns
// rows ty + 16r and columns tx + 16s. The tile goes back to L (a diagonal
// tile its lower part), or with `keep` (the diagonal tile factor_diag takes
// next) stays in sh.a: row-major, lower part, identity past n.
__device__ void update_tile(Shared& sh, float* L, int n, int I, int J, int c, bool keep) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = I * kT + ty + 16 * r, q = J * kT + tx + 16 * s;
      acc[r][s] = (i < n && q < n) ? __ldcg(L + (size_t)i * n + q) : 0.f;
    }
  load_tile(sh.a, L, n, I * kT, c * kT);
  load_tile(sh.b, L, n, J * kT, c * kT);
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < kT; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = *reinterpret_cast<const float4*>(&sh.a[ty + 16 * r][k]);
#pragma unroll
    for (int s = 0; s < 4; ++s) y[s] = *reinterpret_cast<const float4*>(&sh.b[tx + 16 * s][k]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float t = acc[r][s];
        t = fmaf(-x[r].x, y[s].x, t);
        t = fmaf(-x[r].y, y[s].y, t);
        t = fmaf(-x[r].z, y[s].z, t);
        t = fmaf(-x[r].w, y[s].w, t);
        acc[r][s] = t;
      }
  }
  __syncthreads();   // the operand tiles are free again
  if (keep) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int li = ty + 16 * r, lq = tx + 16 * s, i = I * kT + li;
        sh.a[li][lq] = i < n ? (lq <= li ? acc[r][s] : 0.f) : (li == lq ? 1.f : 0.f);
      }
    __syncthreads();
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int li = ty + 16 * r, lq = tx + 16 * s, i = I * kT + li, q = J * kT + lq;
      if (i < n && q < n && (I > J || lq <= li)) L[(size_t)i * n + q] = acc[r][s];
    }
}

// The two triangular kernels below work on a 64 × 64 tile x in shared
// memory, left-looking over blocks of 16 columns j0 = 0, 16, 32, 48, with
// the finished columns also kept transposed (yT[t][j] = L[j][t]), so that
// a thread reads one x entry and four adjacent yT entries a term: first
// every entry of the block subtracts the finished columns t < j0 (t
// ascending), then a thread a row finishes its 16 entries by substitution
// against the block's 16 × 16 diagonal factor D — x_j ·= 1/d_j, then
// x_k −= x_j·D_kj for k > j — so each entry sees the terms t = 0, 1, … in
// order, as a right-looking sweep would.

// x[i][j] −= Σ_{t < j0} x[i][t]·yT[t][j] for rows i ∈ [i0, 64) and the 16
// block columns j (above the diagonal too: those entries are never read):
// a thread a row and 4 adjacent columns
__device__ __forceinline__ void block_left(float (*x)[kLd], const float (*yT)[kLd], int i0,
                                           int j0) {
  const int i = i0 + threadIdx.x / 4, jq = j0 + 4 * (threadIdx.x % 4);
  if (j0 == 0 || i >= kT) return;
  float a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = x[i][jq + r];
#pragma unroll 4
  for (int t = 0; t < j0; ++t) {
    const float u = x[i][t];
    const float4 v = *reinterpret_cast<const float4*>(&yT[t][jq]);
    a[0] = fmaf(-u, v.x, a[0]);
    a[1] = fmaf(-u, v.y, a[1]);
    a[2] = fmaf(-u, v.z, a[2]);
    a[3] = fmaf(-u, v.w, a[3]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) x[i][jq + r] = a[r];
}

// rows i ∈ [i0, 64) of block j0: substitution against the diagonal factor
// D (D_kj = yT[j0 + j][j0 + k]) with reciprocal pivots rd[j0..]; a thread
// a row
__device__ __forceinline__ void block_solve(float (*x)[kLd], const float (*yT)[kLd],
                                            const float* rd, int i0, int j0) {
  const int i = i0 + threadIdx.x;
  if (i >= kT) return;
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = x[i][j0 + k];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    v[j] *= rd[j0 + j];
#pragma unroll
    for (int k = j + 1; k < 16; ++k) v[k] = fmaf(-v[j], yT[j0 + j][j0 + k], v[k]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) x[i][j0 + k] = v[k];
}

// warp 0 factors the 16 × 16 diagonal block at (j0, j0) of x: every lane
// holds the whole lower block in registers and factors it itself (no
// shuffles or shared memory on the column-to-column chain; a shuffle costs
// more than the arithmetic it would save), then lane l writes row l (to x,
// and transposed to yT).
// d = p·rsqrt(p) with p clamped at 1e-30 (a NaN stays NaN); the entries
// below scale by rsqrt(p).
__device__ __forceinline__ void block_factor(float (*x)[kLd], float (*yT)[kLd], float* d,
                                             float* rd, int j0) {
  const int l = threadIdx.x;
  float m[16][16];   // lower part only
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int k = 0; k <= i; ++k) m[i][k] = x[j0 + i][j0 + k];
  float r[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float p = m[j][j] < 1e-30f ? 1e-30f : m[j][j];   // NaN fails the test
    r[j] = rsqrtf(p);
    m[j][j] = p * r[j];
#pragma unroll
    for (int i = j + 1; i < 16; ++i) m[i][j] *= r[j];
#pragma unroll
    for (int i = j + 1; i < 16; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k) m[i][k] = fmaf(-m[i][j], m[k][j], m[i][k]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i == l) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        x[j0 + i][j0 + k] = m[i][k];
        yT[j0 + k][j0 + i] = m[i][k];
      }
      d[j0 + i] = m[i][i];
      rd[j0 + i] = r[i];
    }
}

// factor the diagonal tile (c, c) of L in place; its reciprocal pivots go
// to rdiag[c·64 ..] for the panel's solves. `in_smem`: update_tile left the
// tile in sh.a; else it is read from L. A ragged tile (w < 64) is padded
// with the identity, as the reference pads W.
__device__ void factor_diag(Shared& sh, float* L, float* rdiag, int n, int c, bool in_smem) {
  const int tid = threadIdx.x;
  const int w = min(kT, n - c * kT);
  float* base = L + (size_t)(c * kT) * n + c * kT;
  if (!in_smem) {
#pragma unroll 16
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, q = e % kT;
      sh.a[i][q] = (i < w && q <= i) ? __ldcg(base + (size_t)i * n + q) : (i == q ? 1.f : 0.f);
    }
    __syncthreads();
  }
  for (int j0 = 0; j0 < kT; j0 += 16) {
    block_left(sh.a, sh.b, j0, j0);
    __syncthreads();
    if (tid < 32) block_factor(sh.a, sh.b, sh.d, sh.rd, j0);
    __syncthreads();
    block_solve(sh.a, sh.b, sh.rd, j0 + 16, j0);
    __syncthreads();
    for (int e = tid; e < 16 * (kT - j0 - 16); e += kThreads) {   // the block's rows below D
      const int j = j0 + 16 + e / 16, t = j0 + e % 16;
      sh.b[t][j] = sh.a[j][t];
    }
    __syncthreads();
  }
  if ((n & 3) == 0 && w == kT) {   // whole rows, zeros above the diagonal
#pragma unroll
    for (int u = 0; u < kT * kT / 4 / kThreads; ++u) {
      const int e = tid + kThreads * u, i = e / 16, q = 4 * (e % 16);
      float4 v = *reinterpret_cast<const float4*>(&sh.a[i][q]);
      v.x = q <= i ? v.x : 0.f;
      v.y = q + 1 <= i ? v.y : 0.f;
      v.z = q + 2 <= i ? v.z : 0.f;
      v.w = q + 3 <= i ? v.w : 0.f;
      *reinterpret_cast<float4*>(base + (size_t)i * n + q) = v;
    }
  } else {
#pragma unroll 16
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, q = e % kT;
      if (i < w && q <= i) base[(size_t)i * n + q] = sh.a[i][q];
    }
  }
  if (tid < kT) rdiag[c * kT + tid] = sh.rd[tid];
  __syncthreads();
}

// L_Ic = A_Ic · L_cc⁻ᵀ for the 64 rows of tile I (c < T − 1: full width)
__device__ void solve_tile(Shared& sh, float* L, const float* rdiag, int n, int I, int c) {
  const int tid = threadIdx.x;
  float* base = L + (size_t)(I * kT) * n + c * kT;
  load_tile(sh.a, L, n, I * kT, c * kT);
  load_tile_t(sh.b, L, n, c * kT, c * kT);
  if (tid < kT) sh.rd[tid] = __ldcg(rdiag + c * kT + tid);
  __syncthreads();
  for (int j0 = 0; j0 < kT; j0 += 16) {
    block_left(sh.a, sh.b, 0, j0);
    __syncthreads();
    block_solve(sh.a, sh.b, sh.rd, 0, j0);
    __syncthreads();
  }
  const int rows = min(kT, n - I * kT);
#pragma unroll 16
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int i = e / kT, q = e % kT;
    if (i < rows) base[(size_t)i * n + q] = sh.a[i][q];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const float* __restrict__ W, float* L, float* rdiag, unsigned* sync,
                int n) {
  __shared__ __align__(16) Shared sh;
  const int T = (n + kT - 1) / kT, total = col_start(T, T);
  const int G = gridDim.x;
  unsigned* flags = sync + 2;   // flags[c]: L_cc is published
  unsigned generation = 0;
  for (int c = 0; c < T; ++c) {
    const int cs = col_start(c, T), ce = col_start(c + 1, T);
    // the diagonal tile first: update (or copy), factor, publish
    if (cs % G == static_cast<int>(blockIdx.x)) {
      if (c == 0) {
        copy_tile(W, L, n, 0, 0);
        __syncthreads();
      } else {
        update_tile(sh, L, n, c, c, c - 1, true);
      }
      factor_diag(sh, L, rdiag, n, c, c > 0);
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(flags + c, 1u);
      }
    }
    // then every other owned tile of columns ≥ c, panel c's first
    for (int idx = first_owned(cs + 1); idx < total; idx += G) {
      int I, J;
      tile_of(idx, T, I, J);
      if (c == 0) copy_tile(W, L, n, I, J);
      else update_tile(sh, L, n, I, J, c - 1, false);
    }
    // then panel c's solves, once L_cc is out
    bool waited = false;
    for (int idx = first_owned(cs + 1); idx < ce; idx += G) {
      if (!waited) {
        __syncthreads();
        if (threadIdx.x == 0) {
          while (ld_acquire(flags + c) == 0u) {
          }
          __threadfence();
        }
        __syncthreads();
        waited = true;
      }
      solve_tile(sh, L, rdiag, n, c + idx - cs, c);
    }
    if (c + 1 < T) grid_barrier(sync, generation);
  }
}

}  // namespace

// W (n, n) fp32 (lower triangle read); L (n, n) fp32 output, every element
// written; rdiag: 64·⌈n/64⌉ fp32 (the reciprocal pivots); sync: ⌈n/64⌉ + 2
// uint32 (zeroed here). One memset and one cooperative launch on `stream`,
// its grid every block that fits co-resident (at most one a tile).
extern "C" int cholesky_launch(const void* W, void* L, void* rdiag, void* sync, int n,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return cudaErrorInvalidValue;
  const int T = (n + kT - 1) / kT, tiles = T * (T + 1) / 2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cholesky_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  err = cudaMemsetAsync(sync, 0, (size_t)(T + 2) * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  const float* w = static_cast<const float*>(W);
  float* l = static_cast<float*>(L);
  float* r = static_cast<float*>(rdiag);
  unsigned* s = static_cast<unsigned*>(sync);
  void* args[] = {&w, &l, &r, &s, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cholesky_kernel), grid,
                                    kThreads, args, 0, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
