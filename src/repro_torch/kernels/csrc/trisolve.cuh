// trisolve: w = L⁻ᵀ L⁻¹ u, L (n, n) fp32 lower, u (n, k) fp32 given as P
// fixed-order partials part (P, n, k) (u[i, c] = Σ_p part[p, i, c], p
// ascending), n ≤ 32768, any k. Included by serve_solve.cu.
//
// Replaces the in-kernel _trisolve of src/repro/kernels/serve_solve.py
// (inside serve_solve_pallas): a masked row-by-row substitution, 2n
// sequential steps over L in VMEM.
//
// Bound: L's lower triangle read once and u, w once, 2.1 MB at n = 1024
// (0.6 µs at 3.35 TB/s), and 2n²k flop (under a µs): neither binds. The
// chain of 2n dependent rows does. Here:
//
//   * one thread-block cluster of kCluster = 8 blocks (the portable size)
//     takes up to KT = 16 columns of u together, so L is read once for all
//     of them (more clusters for more columns, KT from a shape rule that
//     keeps a block's rows in shared memory: kernels/serve_solve.py
//     trisolve_columns);
//   * panels of kB = 64 rows go round the cluster (panel q to block
//     q mod 8); each block keeps its panels' rows of the right-hand side in
//     shared memory for the whole solve;
//   * step p: the owner of panel p solves its diagonal block, a warp a
//     column of u (a lane two rows, blocks of eight rows solved in every
//     lane after one round of shuffles), leaves the solved rows in its
//     shared memory, pushes them into the shared memory of the next
//     panel's owner with st.async (each store counted on that block's
//     mbarrier), and arrives at the cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire);
//     after its wait every other block with rows left to update copies the
//     64 × KT solved values out of the owner's shared memory (distributed
//     shared memory) and updates its rows: a 64 × 64 tile of L times the
//     panel, in fixed order (update_rows);
//   * lookahead: the owner of panel p + 1 (p − 1 going back) staged, a
//     step early with cp.async, its diagonal block and the two tiles that
//     tie its panel to panels p and p − 1; it applies the second with the
//     copy of step p − 1, then takes the pushed panel as soon as its
//     mbarrier completes (arrive.expect_tx for the bytes the owner stores),
//     applies the first and solves. It takes its wait on the cluster
//     barrier of the step before only then, just before the solve and its
//     push (every block has arrived at that step, so none still reads
//     what the push overwrites), and updates its other tiles of the last
//     two steps after the solve, off the chain; every
//     other block updates its tiles of a step between its next arrive and
//     wait (a ring of two tiles streamed from L2 with cp.async, one ahead);
//   * the backward pass stages L's tiles transposed into shared memory, so
//     it needs no copy of Lᵀ and both passes read a tile by rows; nothing
//     is summed across blocks, so there is no float atomic and no
//     reduction: repeats are bit-identical.
// The chain is 2n/64 steps of (a 64-row warp solve, an mbarrier hand-off
// between two SMs and one tile update). Measured on an H100
// (tools/triangular_trace.py, PERF.md §6), a step is paced by the cluster
// barrier rather than by the solve: the next panel's owner waits on the
// barrier of the step before (for the copy its second tile needs) and
// starts its step ≈ 2.3–2.6 µs after that step's solve, against ≈ 1.7–2.0
// µs for a solve (0.9–1.1 µs alone). A design with no barrier a step — every
// solved panel pushed to every block into a ring, its reuse guarded by
// per-block progress counters — is the next step.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace tri {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;     // blocks a cluster; mirrored in kernels/serve_solve.py
constexpr int kB = 64;          // panel rows
constexpr int kThreads = 512;
constexpr int kPitch = 68;      // tile row pitch (floats): 16-byte rows, float4 reads conflict-free
constexpr int kDPitch = kB + 1; // diagonal block pitch: column reads conflict-free
constexpr int kSmemLimit = 232448 - 1024;   // the dynamic part; static mbarrier beside it

// Floats of dynamic shared memory for n rows and KT columns: the right-hand
// side of the block's panels, the current panel's solved values (copied, and
// pushed by the owner when this block solves next), the diagonal block and
// its reciprocal pivots, the two tiles of the panel it solves next and a
// ring of two trailing tiles.
__host__ __device__ inline int smem_floats(int n, int kt) {
  const int panels = (n + kB - 1) / kB;
  const int slots = (panels + kCluster - 1) / kCluster;
  return slots * kB * kt + 2 * kB * kt + kB * kDPitch + kB + 4 * kB * kPitch;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The shared::cluster address of `p`'s offset in block `rank`'s shared memory.
__device__ __forceinline__ unsigned remote_addr(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// An asynchronous store of v into another block's shared memory that counts
// its 4 bytes against that block's mbarrier (complete_tx): no fence and no
// wait on the storing side.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(addr), "f"(v), "r"(bar)
               : "memory");
}

// This block's arrival on its own mbarrier for the current phase, expecting
// `bytes` of asynchronous stores into its shared memory.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for phase `parity` of this block's mbarrier to complete (acquire at
// cluster scope).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst[r·pitch + c] ← L[r0 + r, c0 + c] for r, c < 64 (dst[c·pitch + r] with
// `transpose`), 0 past n (or, with `lower`, above the diagonal).
// Asynchronous: the caller commits and waits. `vec`: L's rows are 16-byte
// aligned (n % 4 == 0, aligned base), so a plain tile goes 16 bytes a copy.
__device__ __forceinline__ void stage_tile(float* dst, int pitch, const float* __restrict__ L,
                                           int n, int r0, int c0, bool lower, bool vec,
                                           bool transpose = false) {
  if (vec && (pitch & 3) == 0 && !lower && !transpose) {
    for (int e = threadIdx.x; e < kB * kB / 4; e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      float* d = dst + r * pitch + c;
      if (r0 + r < n && c0 + c < n)
        cp_async16(d, L + static_cast<size_t>(r0 + r) * n + c0 + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
      const int r = e >> 6, c = e & 63;
      float* d = dst + (transpose ? c * pitch + r : r * pitch + c);
      if (r0 + r < n && c0 + c < n && (!lower || c <= r))
        cp_async4(d, L + static_cast<size_t>(r0 + r) * n + c0 + c);
      else
        *d = 0.f;
    }
  }
}

// rows[l·KT + c] −= Σ_j T[l·kPitch + j]·y[j·KT + c] for the 64 rows of one
// panel (T a tile of L forward, of Lᵀ backward: staged transposed). G
// threads an output (8 at KT = 1, 2 at 4, else 1), each over 64/G
// consecutive j in four partial sums (j mod 4) added pairwise, then summed
// across the G lanes by xor shuffles (the same bits in every lane): a
// chain of 64/(4G) FMAs, not 64.
template <int KT>
__device__ __forceinline__ void update_rows(float* rows, const float* T, const float* y) {
  constexpr int G = KT == 1 ? 8 : KT == 4 ? 2 : 1;
  constexpr int C = kB / G;
  const int part = threadIdx.x % G;
  for (int e = threadIdx.x / G; e < kB * KT; e += kThreads / G) {
    const int l = e / KT, c = e % KT;
    const float* a = T + l * kPitch + part * C;
    const float* yy = y + part * C * KT + c;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j < C; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + j);
      s0 = fmaf(v.x, yy[(j + 0) * KT], s0);
      s1 = fmaf(v.y, yy[(j + 1) * KT], s1);
      s2 = fmaf(v.z, yy[(j + 2) * KT], s2);
      s3 = fmaf(v.w, yy[(j + 3) * KT], s3);
    }
    float sum = (s0 + s1) + (s2 + s3);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) rows[e] -= sum;
  }
}

// The owner's diagonal solve of one panel: warp c < KT takes column c, lane
// rows lane and lane + 32 of the panel (x0, x1). Forward, D y = r: once row
// t is final, y_t = x_t·(1/D[t, t]) and every row a below it takes
// D[a, t]·y_t off; backward, Dᵀ w = r, the same bottom-up with D[t, a].
// Rows go in blocks of eight: the lanes fetch the block's eight current
// values with eight shuffles at once, every lane solves the 8 × 8 diagonal
// block itself (the same operations in the same order as the lanes of
// those rows), and each lane then takes the eight solved values off its
// own rows. So the chain is eight shuffle latencies a panel, not 64. dinv
// is 0 past n, so those rows come out 0. The solved rows go to `rows` and,
// when `to` ≥ 0, by st.async to `push` in block `to`, counted on its
// mbarrier `bar`.
template <int KT, bool BACKWARD>
__device__ __forceinline__ void solve_diag(float* rows, const float* D, const float* dinv,
                                           const float* push, int to,
                                           unsigned long long* bar) {
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
  float x0 = rows[lane * KT + c], x1 = rows[(lane + 32) * KT + c];
  // the coefficient that row a takes y_t off with
  auto coef = [&](int a, int t) { return BACKWARD ? D[t * kDPitch + a] : D[a * kDPitch + t]; };
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int t0 = BACKWARD ? 56 - 8 * b : 8 * b;   // the block's first row
    const bool low = t0 < 32;                       // its rows are in x0
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __shfl_sync(0xffffffffu, low ? x0 : x1, (t0 + u) & 31);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = BACKWARD ? 7 - i : i;
      const int t = t0 + u;
      const float y = v[u] * dinv[t];
#pragma unroll
      for (int w = 0; w < 8; ++w)
        if (BACKWARD ? w < u : w > u) v[w] = fmaf(-coef(t0 + w, t), y, v[w]);
      if (BACKWARD) {
        if (lane < t) x0 = fmaf(-coef(lane, t), y, x0);
        if (!low && lane + 32 < t) x1 = fmaf(-coef(lane + 32, t), y, x1);
      } else {
        if (low && lane > t) x0 = fmaf(-coef(lane, t), y, x0);
        if (lane + 32 > t) x1 = fmaf(-coef(lane + 32, t), y, x1);
      }
    }
  }
  x0 *= dinv[lane];
  x1 *= dinv[lane + 32];
  rows[lane * KT + c] = x0;
  rows[(lane + 32) * KT + c] = x1;
  if (to >= 0) {
    const unsigned b = remote_addr(bar, to);
    st_async(remote_addr(push + lane * KT + c, to), x0, b);
    st_async(remote_addr(push + (lane + 32) * KT + c, to), x1, b);
  }
}

template <int KT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
trisolve_kernel(const float* __restrict__ L, const float* __restrict__ part, int P, int n,
                int k, int vec, float* __restrict__ w) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned long long pushed;     // completes a phase when a panel is stored here
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = static_cast<int>(blockIdx.x / kCluster) * KT;
  const int panels = (n + kB - 1) / kB;
  const int slots = (panels + kCluster - 1) / kCluster;
  float* r = sm;                            // [slot][64][KT]: panel rank + 8·slot
  float* y = r + slots * kB * KT;           // a solved panel, copied from its owner
  float* yn = y + kB * KT;                  // a solved panel, pushed by its owner
  float* D = yn + kB * KT;                  // the diagonal block this block solves next
  float* dinv = D + kB * kDPitch;
  float* T = dinv + kB;                     // the next panel's tile of the step before
  float* T2 = T + kB * kPitch;              // ... and of the step before that
  float* U = T2 + kB * kPitch;              // ring of two trailing tiles
  const int tid = threadIdx.x;
  const bool solver_warp = tid < 32 * KT;
  auto owner = [](int p) { return p % kCluster; };
  auto rows_of = [&](int p) { return r + (p / kCluster) * kB * KT; };
  // first panel ≥ lo that this block holds
  auto first_own = [&](int lo) {
    return lo + ((rank - lo % kCluster) % kCluster + kCluster) % kCluster;
  };
  // step t: panel pan(t) is solved, forward (t < panels) then backward; its
  // lookahead panel nxt(t) is solved at step t + 1 (none past the ends)
  auto back = [&](int t) { return t >= panels; };
  auto pan = [&](int t) { return back(t) ? 2 * panels - 1 - t : t; };
  auto nxt = [&](int t) { return back(t) ? pan(t) - 1 : pan(t) + 1; };
  auto has_nxt = [&](int t) { return t >= 0 && t < 2 * panels && nxt(t) >= 0 && nxt(t) < panels; };

  // u for the block's panels, partials summed in fixed order
  for (int e = tid; e < slots * kB * KT; e += kThreads) {
    const int q = (e / (kB * KT)) * kCluster + rank;
    const int i = q * kB + (e / KT) % kB, c = c0 + e % KT;
    float s = 0.f;
    if (q < panels && i < n && c < k)
      for (int p = 0; p < P; ++p) s += part[(static_cast<size_t>(p) * n + i) * k + c];
    r[e] = s;
  }
  auto pivots = [&](int p) {
    if (tid < kB) dinv[tid] = p * kB + tid < n ? 1.f / D[tid * kDPitch + tid] : 0.f;
  };
  // step t's tile of panel q: (q, pan(t)) forward, (pan(t), q) transposed back
  auto stage = [&](float* dst, int t, int q) {
    if (back(t)) stage_tile(dst, kPitch, L, n, pan(t) * kB, q * kB, false, vec, true);
    else stage_tile(dst, kPitch, L, n, q * kB, pan(t) * kB, false, vec);
  };
  // the block that solves at step t + 1 stages, during step t − 1, the tiles
  // it applies to that panel at step t (its lookahead) and t − 1, and its
  // diagonal block
  auto stage_ahead = [&](int t) {
    if (!has_nxt(t) || owner(nxt(t)) != rank) return;
    stage(T, t, nxt(t));
    if (t >= 1 && back(t - 1) == back(t)) stage(T2, t - 1, nxt(t));
    stage_tile(D, kDPitch, L, n, nxt(t) * kB, nxt(t) * kB, true, vec);
    cp_async_commit();
  };
  // step t's tiles other than its lookahead's (panels past nxt(t) going
  // forward, before it going back), streamed through the ring U; `skip`, a
  // panel whose tile was applied ahead, is left out (it is the first
  // forward, the last backward)
  auto trailing = [&](int t, const float* ys, int skip) {
    if (t < 0) return;
    int lo = back(t) ? first_own(0) : first_own(pan(t) + 2);
    int hi = back(t) ? pan(t) - 1 : panels;
    if (lo == skip) lo += kCluster;
    if (skip >= 0 && skip < hi && skip + kCluster >= hi) hi = skip;
    if (lo >= hi) return;
    stage(U, t, lo);
    cp_async_commit();
    int slot = 0;
    for (int q = lo; q < hi; q += kCluster, slot ^= 1) {
      if (q + kCluster < hi) {
        stage(U + (slot ^ 1) * kB * kPitch, t, q + kCluster);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      update_rows<KT>(rows_of(q), U + slot * kB * kPitch, ys);
      __syncthreads();
    }
  };
  if (tid == 0) mbar_init(&pushed, 1);
  if (owner(0) == rank) stage_tile(D, kDPitch, L, n, 0, 0, true, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (owner(0) == rank) pivots(0);
  stage_ahead(0);
  cluster_arrive();   // every block has started and set up its mbarrier
  cluster_wait();

  // Steps s = 0 .. 2·panels − 1. Every thread arrives at the cluster barrier
  // once a step and waits on it before its next arrive. The block that
  // solves next (`ahead`) instead waits on its mbarrier for the pushed
  // panel, updates its panel with it and solves; only then does it take
  // the barrier's wait (`deferred`) and its other tiles of the last two
  // steps.
  bool was_ahead = false, deferred = false;
  unsigned pushes = 0;      // phases of `pushed` this block has waited for
  for (int s = 0; s < 2 * panels; ++s) {
    const int p = pan(s), next = nxt(s);
    const bool has_next = has_nxt(s);
    const bool ahead = has_next && owner(next) == rank;
    const bool solving = owner(p) == rank;
    stage_ahead(s + 1);
    // the last step's wait, deferred to the solve: every block has then
    // arrived at step s − 1, so none still reads the panel pushed into the
    // next owner's yn three or more steps ago
    if (deferred) cluster_wait();
    if (solving && solver_warp) {
      const int to = has_next ? owner(next) : -1;
      if (back(s)) solve_diag<KT, true>(rows_of(p), D, dinv, yn, to, &pushed);
      else solve_diag<KT, false>(rows_of(p), D, dinv, yn, to, &pushed);
    }
    cluster_arrive();
    if (ahead) {
      cp_async_wait<0>();
      __syncthreads();
      pivots(next);
      if (s >= 1 && back(s - 1) == back(s)) update_rows<KT>(rows_of(next), T2, y);
      if (tid == 0) mbar_expect(&pushed, kB * KT * sizeof(float));
      mbar_wait(&pushed, pushes++ & 1u);
      update_rows<KT>(rows_of(next), T, yn);
      __syncthreads();
    } else {
      if (was_ahead) {          // the solver: its deferred tiles
        trailing(s - 2, y, p);
        trailing(s - 1, yn, -1);
      } else {
        trailing(s - 1, y, -1);
      }
      cluster_wait();
      // a block with rows left to update after this step (below p forward,
      // above p backward) copies the solved panel from its owner
      const bool left = back(s) ? p > 0 && rank < p : p + 1 < panels;
      if (left) {
        const float* src = cluster.map_shared_rank(rows_of(p), owner(p));
        for (int e = tid; e < kB * KT; e += kThreads) y[e] = src[e];
      }
      __syncthreads();
    }
    deferred = ahead;
    was_ahead = ahead;
  }
  cluster_arrive();   // no block leaves while another may read its rows
  cluster_wait();
  for (int e = tid; e < slots * kB * KT; e += kThreads) {
    const int q = (e / (kB * KT)) * kCluster + rank;
    const int i = q * kB + (e / KT) % kB, c = c0 + e % KT;
    if (q < panels && i < n && c < k) w[static_cast<size_t>(i) * k + c] = r[e];
  }
}

template <int KT>
cudaError_t launch(const float* L, const float* part, int P, int n, int k, float* w,
                   cudaStream_t st) {
  const size_t smem = static_cast<size_t>(smem_floats(n, KT)) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(trisolve_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int clusters = (k + KT - 1) / KT;
  const int vec = (n & 3) == 0 && (reinterpret_cast<size_t>(L) & 15) == 0;
  trisolve_kernel<KT><<<clusters * kCluster, kThreads, smem, st>>>(L, part, P, n, k, vec, w);
  return cudaGetLastError();
}

}  // namespace tri

// w (n, k) = L⁻ᵀ L⁻¹ Σ_p part[p] on `st`: one cluster launch; kt, the columns
// a cluster takes (1, 4, 8 or 16), from kernels/serve_solve.py
// trisolve_columns.
inline cudaError_t launch_trisolve(const float* L, const float* part, int P, int n, int k,
                                   int kt, float* w, cudaStream_t st) {
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  switch (kt) {
    case 1: return tri::launch<1>(L, part, P, n, k, w, st);
    case 4: return tri::launch<4>(L, part, P, n, k, w, st);
    case 8: return tri::launch<8>(L, part, P, n, k, w, st);
    case 16: return tri::launch<16>(L, part, P, n, k, w, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro
