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
// and at n = 256 there are only 3 lower tiles of 128, so both routes are
//
//   1. a partial kernel: one block per (lower tile, chunk of m); only tiles
//      on or below the diagonal are computed, and a diagonal tile stages one
//      operand for both sides. Each block writes its tile's partial sum to
//      scratch (P, tiles, 128, 128);
//   2. gram_reduce_kernel: sums the P partials of each element in a fixed
//      order (p ascending), adds W_in, writes W[i, j] and mirrors W[j, i].
//      No float atomics, and the split of m depends on the shape only, so a
//      repeated call is bit-identical.
//
// u accumulates on diagonal tiles only (each row band counts once; the TPU
// kernel gates on j == 0 instead), from the staged tile and v, which arrives
// in S's storage dtype: the wrapper rounds v to it, as gram_sv_pallas does
// (gram_sv.py:86). It is a CUDA-core dot product in a fixed order.
//
// The tensor-core route (gram_tc_kernel), where TMA can read the window (its
// row stride and base 16-byte aligned: kernels/gram.py tensor_core_route):
//
//   * Bound: operations. The reference contracts fp32 at Precision.HIGHEST,
//     so the fp32 window takes 3xTF32: big·bigᵀ + big·smallᵀ + small·bigᵀ
//     with big = x rounded to the nearest TF32 value and small = x − big,
//     exact in fp32 and of either sign (the tensor core reads small's top 19
//     bits); one TF32 pass alone is ~7e-4 off, the three ~3e-7 (the fp32
//     FMAs' ~1e-7). Truncating x for big instead (the bits TF32 ignores)
//     makes small share x's sign, and every diagonal x² then comes out low:
//     a bias, like a smaller damping, that took path B's NGD step past its
//     gate. Three passes over the lower tiles at (1024, 100,000) are
//     3.5·10¹¹ flop, 0.72 ms at the dense TF32 rate; a bf16 window is one
//     pass of exact products at twice that rate. Each block reads two row
//     bands, so the window crosses L2 ≈ T times (T = ceil(n/128)): 3.3 GB at
//     that shape in fp32, the other limit.
//   * Block: 3 warpgroups. One thread of WG 2 issues 2-D TMA loads (boxes of
//     128 rows × 128 bytes: 32 fp32 or 64 bf16 columns, 128-byte swizzle)
//     into a ring of stages completed by mbarriers; WG 0 and 1 each own 64
//     rows × 128 columns of the tile: wgmma m64n128k8 tf32 (fp32 window) or
//     m64n128k16 bf16, both operands K-major as S lies, with no transpose.
//   * The tensor cores' accumulator drops bits on every add (it rounds
//     toward zero): summed over a whole chunk that bias grows with the chunk
//     and passed the 1e-4 gate at (2048, 200,000). Each stage's products go
//     to two fresh accumulators instead (even and odd K steps: 6 wgmmas each
//     fp32, 2 bf16), which are added into an fp32 sum on the CUDA cores once
//     they are done (wait_group 0: reading an accumulator behind wait_group
//     1 makes ptxas serialize every wgmma). The producer gives its registers
//     to the consumers (setmaxnreg) for the three 64-float sums.
//   * fp32: the consumers overwrite the staged boxes with big and write
//     small into one of two small buffers with the same swizzled layout (an
//     elementwise transform at the same byte offsets, so the descriptors
//     only change base), fence them to the async proxy and meet at a named
//     barrier. A stage's split runs while the previous stage's products are
//     on the tensor cores.
//   * Chunks are whole boxes (kernels/gram.py gram_split's depth), so a box
//     never reads into the next chunk; only the last box is zero-filled past
//     m by TMA, and rows past n likewise.
//
// The CUDA-core route (gram_partial_kernel) stays for windows TMA cannot
// read: fp32 FMAs, both operands staged through shared memory in
// double-buffered stages of 16 columns (bf16 widened on load), each thread
// holding an 8×8 sub-tile in registers. Its bound is the fp32 FMA rate
// (≈ 1.6 ms at (1024, 100,000)). Ragged n and m are masked at the edges
// (zeros are staged), so S is never padded or copied.
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core route
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kRows = 128;                  // rows of a band, of a box, of the tile
constexpr int kBoxBytes = kRows * 128;      // 128 rows × 128 bytes
constexpr int kThreads = 384;               // WG 0, 1: consumers; WG 2: the producer
constexpr int kEmptyArrivals = 8;           // consumer warps

// kCols: columns of m a box (and a stage); kSmall: small buffers (fp32 only)
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kCols = 32, kStages = 4, kSmall = 2;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kCols = 64, kStages = 4, kSmall = 0;
};

template <typename T>
struct Layout {
  using C = Cfg<T>;
  static constexpr int kStage = 2 * kBoxBytes;                      // A box, B box
  static constexpr int kSmallBase = C::kStages * kStage;
  static constexpr int kBar = kSmallBase + C::kSmall * kStage;      // full[], empty[]
  static constexpr int kBytes = kBar + 16 * C::kStages + 1024;      // + base alignment
};

// D (64 x 128, fp32) (+)= A·B, A and B tf32 (fp32 words, low 13 bits
// ignored) in shared memory, both K-major
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// x rounded to the nearest TF32 value (ties away), an fp32 word with its low
// 13 bits zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// big = tf32_rna(x) in place and small = x − big (exact in fp32, either
// sign) beside it
__device__ __forceinline__ void split(uint8_t* big, uint8_t* small) {
  const float4 x = *reinterpret_cast<const float4*>(big);
  const float4 b = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  *reinterpret_cast<float4*>(big) = b;
  *reinterpret_cast<float4*>(small) = make_float4(x.x - b.x, x.y - b.y, x.z - b.z, x.w - b.w);
}

__device__ __forceinline__ float vload(const float* v, int j, int m) {
  return j < m ? __ldg(v + j) : 0.f;
}

__device__ __forceinline__ float vload(const __nv_bfloat16* v, int j, int m) {
  return j < m ? __bfloat162float(v[j]) : 0.f;
}

// u partial of one 16-byte chunk (4 fp32 or 8 bf16 columns from j) of a
// row; v is 16-byte aligned (the wrapper sees to it), so a chunk wholly
// inside m is one vector load
__device__ __forceinline__ float dot_chunk(const uint8_t* p, const float* v, int j, int m,
                                           float acc) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 w = j + 3 < m ? __ldg(reinterpret_cast<const float4*>(v + j))
                             : make_float4(vload(v, j, m), vload(v, j + 1, m),
                                           vload(v, j + 2, m), vload(v, j + 3, m));
  acc = fmaf(x.x, w.x, acc);
  acc = fmaf(x.y, w.y, acc);
  acc = fmaf(x.z, w.z, acc);
  return fmaf(x.w, w.w, acc);
}

__device__ __forceinline__ float dot_chunk(const uint8_t* p, const __nv_bfloat16* v, int j,
                                           int m, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  if (j + 7 < m) {
    const uint4 vraw = __ldg(reinterpret_cast<const uint4*>(v + j));
    const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&vraw);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(x[e]), __bfloat162float(w[e]), acc);
    return acc;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(x[e]), vload(v, j + e, m), acc);
  return acc;
}

template <typename T, bool SV>
__global__ void __launch_bounds__(kThreads, 1)
gram_tc_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ v, int m,
               int chunk, float* __restrict__ part, float* __restrict__ part_u,
               int u_stride) {
  using C = Cfg<T>;
  using Lay = Layout<T>;
  constexpr bool kSplit = C::kSmall > 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::kBar);
  uint64_t* empty = full + C::kStages;

  int bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const bool diag = bi == bj;
  const int p = blockIdx.y;
  const int j_begin = p * chunk;
  const int n_iter = (min(m, j_begin + chunk) - j_begin + C::kCols - 1) / C::kCols;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % C::kStages;
        const uint32_t ph = (it / C::kStages) & 1;
        const int col = j_begin + it * C::kCols;
        uint8_t* a = smem + s * Lay::kStage;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(full + s, diag ? kBoxBytes : 2 * kBoxBytes);
        tma_load_2d(a, &map, full + s, col, bi * kRows);
        if (!diag) tma_load_2d(a + kBoxBytes, &map, full + s, col, bj * kRows);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64·wg … 64·wg + 63 of the tile ----
  const int ct = threadIdx.x;                 // 0 … 255
  const int lane = ct % 32;
  // split and u: this thread's row r of the staged band(s), 16-byte chunks
  // 4h … 4h + 3 (half h of the 128-byte row), found through the swizzle
  const int r = ct >> 1, h = ct & 1;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  float tot[64], acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  float uacc = 0.f;

  auto stage_a = [&](int it) { return smem + (it % C::kStages) * Lay::kStage; };
  auto small_a = [&](int it) -> uint8_t* {
    if constexpr (kSplit) return smem + Lay::kSmallBase + (it % C::kSmall) * Lay::kStage;
    return smem + Lay::kSmallBase;
  };
  // wait for stage it; write its small parts (fp32) and add its u part
  auto prepare = [&](int it) {
    uint8_t* a = stage_a(it);
    uint8_t* b = diag ? a : a + kBoxBytes;
    uint8_t* sa = small_a(it);
    uint8_t* sb = diag ? sa : sa + kBoxBytes;
    const int j0 = j_begin + it * C::kCols;
    mbar_wait(full + it % C::kStages, (it / C::kStages) & 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * h + q;
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      if (SV && diag) uacc = dot_chunk(a + off, v, j0 + c * (16 / (int)sizeof(T)), m, uacc);
      if constexpr (kSplit) {
        split(a + off, sa + off);
        if (!diag) split(b + off, sb + off);
      }
    }
    if constexpr (kSplit) fence_proxy_async();
  };

  prepare(0);
  for (int it = 0; it < n_iter; ++it) {
    // every consumer's small parts of stage it are written
    if constexpr (kSplit) asm volatile("bar.sync 1, 256;" ::: "memory");
    const uint32_t a0 = smem_u32(stage_a(it)) + wg * 64 * 128;
    const uint32_t b0 = diag ? smem_u32(stage_a(it)) : smem_u32(stage_a(it)) + kBoxBytes;
    const uint32_t sa0 = smem_u32(small_a(it)) + wg * 64 * 128;
    const uint32_t sb0 = diag ? smem_u32(small_a(it)) : smem_u32(small_a(it)) + kBoxBytes;
    wgmma_fence();
    // K step kk (32 bytes) into acc, which it starts afresh when first
    auto step = [&](float(&acc)[64], int kk) {
      const uint64_t da = desc_sw128(a0 + 32 * kk, 16, 1024);
      const uint64_t db = desc_sw128(b0 + 32 * kk, 16, 1024);
      if constexpr (kSplit) {
        wgmma_tf32_n128(acc, da, db, kk > 1);
        wgmma_tf32_n128(acc, da, desc_sw128(sb0 + 32 * kk, 16, 1024), 1);
        wgmma_tf32_n128(acc, desc_sw128(sa0 + 32 * kk, 16, 1024), db, 1);
      } else {
        wgmma_ss_n128(acc, da, db, kk > 1);
      }
    };
    step(acc0, 0);                            // even steps in acc0, odd in acc1
    step(acc1, 1);
    step(acc0, 2);
    step(acc1, 3);
    wgmma_commit();
    if (it + 1 < n_iter) prepare(it + 1);    // while this stage's products run
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = (tot[i] + acc0[i]) + acc1[i];
    if (lane == 0) mbar_arrive(empty + it % C::kStages);
  }

  // element 4j + e of tot is row 16·warp + g + 8·(e >> 1) of this
  // warpgroup's 64, column 8j + 2·t4 + (e & 1)
  const int warp = (ct % 128) / 32, g = lane / 4, t4 = lane % 4;
  const int row0 = 64 * wg + 16 * warp + g;
  float* out = part + ((size_t)p * gridDim.x + blockIdx.x) * kRows * kRows;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(out + (size_t)row0 * kRows + col) =
        make_float2(tot[4 * j], tot[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(row0 + 8) * kRows + col) =
        make_float2(tot[4 * j + 2], tot[4 * j + 3]);
  }
  if (SV && diag) {
    const float tot = uacc + __shfl_xor_sync(0xffffffffu, uacc, 1);
    if (h == 0) part_u[(size_t)p * u_stride + bi * kRows + r] = tot;
  }
}

// (n, m) row-major, m contiguous: boxes of kCols columns × 128 rows
template <typename T>
bool make_map(CUtensorMap* map, const void* S, int n, int m) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)m * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Cfg<T>::kCols, (cuuint32_t)kRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, dt, 2, const_cast<void*>(S), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool SV>
cudaError_t launch(const void* S, const void* v, float* part, float* part_u, int n, int m,
                   int tiles, int P, int chunk, int u_stride, cudaStream_t st) {
  if (chunk % Cfg<T>::kCols) return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!make_map<T>(&map, S, n, m)) return cudaErrorInvalidValue;
  constexpr int smem = Layout<T>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      gram_tc_kernel<T, SV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gram_tc_kernel<T, SV><<<dim3(tiles, P), kThreads, smem, st>>>(
      map, static_cast<const T*>(v), m, chunk, part, part_u, u_stride);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
int gram_impl(const void* S, const void* v, const float* W_in, float* W, float* u,
              float* part, float* part_u, int n, int m, int tiles, int P, int chunk,
              int tensor_cores, cudaStream_t st) {
  const T* s = static_cast<const T*>(S);
  const int u_stride = ((n + kT - 1) / kT) * kT;
  const dim3 grid(tiles, P);
  cudaError_t err;
  if (tensor_cores) {
    err = v != nullptr ? tc::launch<T, true>(S, v, part, part_u, n, m, tiles, P, chunk,
                                             u_stride, st)
                       : tc::launch<T, false>(S, v, part, part_u, n, m, tiles, P, chunk,
                                              u_stride, st);
  } else {
    if (v != nullptr)
      gram_partial_kernel<T, true><<<grid, kThreads, 0, st>>>(
          s, static_cast<const T*>(v), n, m, chunk, part, part_u, u_stride);
    else
      gram_partial_kernel<T, false><<<grid, kThreads, 0, st>>>(s, nullptr, n, m, chunk, part,
                                                               nullptr, u_stride);
    err = cudaGetLastError();
  }
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
// T = ceil(n/128); P·chunk ≥ m. tensor_cores: the wgmma + TMA route (S's
// base and row stride 16-byte aligned; chunk a multiple of 32 fp32 or 64 bf16
// columns), else the CUDA-core route (chunk a multiple of 16).
extern "C" int gram_launch(const void* S, int bf16, const void* v, const void* W_in, void* W,
                           void* u, void* part, void* part_u, int n, int m, int tiles, int P,
                           int chunk, int tensor_cores, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wi = static_cast<const float*>(W_in);
  float* w = static_cast<float*>(W);
  float* up = static_cast<float*>(u);
  float* pp = static_cast<float*>(part);
  float* pu = static_cast<float*>(part_u);
  return bf16 ? gram_impl<__nv_bfloat16>(S, v, wi, w, up, pp, pu, n, m, tiles, P, chunk,
                                         tensor_cores, st)
              : gram_impl<float>(S, v, wi, w, up, pp, pu, n, m, tiles, P, chunk,
                                 tensor_cores, st);
}
