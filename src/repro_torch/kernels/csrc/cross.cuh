// Split-m cross pass shared by serve_solve.cu and fold.cu.
//
//   part[p, i, c] = sum_{j in chunk p} X_i[j] * Y_c[j]
//
// X_i is row i of an (n, m) row-major window (fp32 or bf16), optionally
// followed by the rows of a second (n2, m) matrix of the same dtype (the fold
// kernel's corner rows). Y_c is column c of V (m, k) fp32 row-major, or row c
// of a (k, m) matrix ("k-major", the fold rows, in the window's dtype).
// Accumulation is fp32.
//
// The TPU kernels run this reduction over m as one sequential grid. Here the
// m axis is split into P chunks so the work spreads over every SM even when
// n is 8; the P partial sums are added in a fixed order by a second pass
// (reduce_partials_kernel, or the substitution kernel for serve_solve), never
// with float atomics, so a repeated call is bit-identical.
//
// Bound: device-memory bytes. Each window element is read once (k/2 flop per
// byte at fp32, k flop per byte at bf16). It streams at that rate only with
// many bytes a lane in flight and no stage barrier in the loads' way, so:
//
// * Wide loads (stream.cuh): a lane reads 16 bytes of a row, 4 fp32 or 8
//   bf16 columns, with ld.global.nc.L1::no_allocate; a warp-step is 128 fp32
//   or 256 bf16 columns of each of the warp's 4 rows. An unaligned window
//   takes scalar loads of the same columns (serve_solve.stream_route).
// * Loads in flight: a block is 8 warps, 32 rows; a stage is 2 warp-steps
//   (1 at KT = 16, where the sums take 64 registers), and on the vector
//   route the next stage's loads are issued before this stage's arithmetic:
//   8 loads of 16 bytes in flight a lane at KT ≤ 8, 64 KB an SM with two
//   blocks, in both dtypes. The scalar route issues them after it (a bf16
//   lane's 8 scalar loads take twice the registers of one 16-byte load).
// * Y off the critical path: the stage's tile of Y (KT columns × the stage's
//   m columns) is staged in shared memory by cp.async, double-buffered, one
//   barrier a stage, issued before the stage's window loads. V (m, k) is
//   transposed on the way (4-byte copies); k-major Y is copied 16 bytes
//   (fp32) or 8 (bf16) at a time, by plain loads on the scalar route. A lane
//   reads 4 of its columns of a Y column with one shared load: an fp32
//   window's 4 columns, or a bf16 window's 8 in two halves, from a layout
//   (ypos) that keeps a warp's reads consecutive.
// * Order: a lane adds its columns of a chunk in ascending order into one
//   fp32 sum a (row, Y column); the 32 lanes' sums are then added by a fixed
//   butterfly. The order depends on the shape and the dtype only
//   (ref.sv_cross_tiles_ref emulates it; the card matches it bit for bit).
// * Tensor cores for a bf16 window at 8 or 16 right-hand sides a block
//   (tc:: below): there the CUDA cores' FMAs, k a byte, bind before the
//   bytes (their kernel spills at KT = 8 and 16, and the cross pass takes
//   1.03–1.77× as long there, tools/stream_ab.py), so the products run on
//   mma.sync, the window and Y staged through a ring of shared memory.
//   serve_solve.cross_tensor_cores mirrors the rule.
//
// Times against the byte bound, and the variants tried: PERF.md §6.
#pragma once

#include "stream.cuh"

namespace repro {

constexpr int kRowsPerBlock = 32;    // mirrored in Python (serve_solve.py)

// 8 warps of 4 rows; a stage of 2 warp-steps, 1 at KT = 16. Mirrored in
// Python (serve_solve.cross_tile).
template <int KT>
struct CrossCfg {
  static constexpr int kRows = 4;
  static constexpr int kThreads = 32 * kRowsPerBlock / kRows;
  static constexpr int kSteps = KT > 8 ? 1 : 2;
};

template <typename TX, int KT>
__host__ __device__ constexpr int cross_stage_cols() {
  return 32 * stream::Lane<TX>::kVec * CrossCfg<KT>::kSteps;
}

// Y's row pitch in shared memory: the stage's columns and 16 bytes, so the
// transposing 4-byte copies of V spread over the banks
template <typename TX, typename TY, int KT>
__host__ __device__ constexpr int cross_pitch() {
  return cross_stage_cols<TX, KT>() + 16 / static_cast<int>(sizeof(TY));
}

template <typename TX, typename TY, int KT>
__host__ __device__ constexpr int cross_smem_bytes() {
  return 2 * KT * cross_pitch<TX, TY, KT>() * static_cast<int>(sizeof(TY));
}

// Where column jj of a stage sits in a row of the shared Y tile. A bf16
// window gives a lane 8 columns, which it takes 4 at a time: half h of lane
// l in warp-step s sits at [s][h][l][4], so that a warp's reads of a half
// are consecutive. An fp32 window's lane reads its 4 columns as they lie.
template <typename TX>
__device__ __forceinline__ int ypos(int jj) {
  if constexpr (sizeof(TX) == 4)
    return jj;
  else
    return (jj & ~255) | ((jj & 4) << 5) | ((jj >> 3 & 31) << 2) | (jj & 3);
}

// Stage s's tile of Y: ys[c][ypos(jj)] = Y_{c0+c}[j0 + jj], zero past j_end
// or k.
template <typename TX, typename TY, bool Y_KMAJOR, int KT, bool VEC>
__device__ __forceinline__ void stage_y(TY* ys, const TY* __restrict__ Y, int m, int k,
                                        int c0, int j0, int j_end) {
  constexpr int kTS = cross_stage_cols<TX, KT>();
  constexpr int kPitch = cross_pitch<TX, TY, KT>();
  constexpr int kThreads = CrossCfg<KT>::kThreads;
  if constexpr (!Y_KMAJOR) {
    static_assert(sizeof(TY) == 4, "V is fp32");
    // consecutive threads walk V's row (c fastest): coalesced when k fills KT
    for (int e = threadIdx.x; e < KT * kTS; e += kThreads) {
      const int jj = e / KT, c = e % KT;
      const int j = j0 + jj, cg = c0 + c;
      const bool ok = j < j_end && cg < k;
      stream::cp_async4(ys + c * kPitch + ypos<TX>(jj), ok ? Y + (size_t)j * k + cg : Y, ok);
    }
  } else if constexpr (VEC && sizeof(TY) == 4) {   // fp32 rows, 16 bytes a copy
    for (int e = threadIdx.x; e < KT * (kTS / 4); e += kThreads) {
      const int c = e / (kTS / 4), jj = (e % (kTS / 4)) * 4;
      const int j = j0 + jj, cg = c0 + c;
      const bool ok = j < j_end && cg < k;
      stream::cp_async16(ys + c * kPitch + jj, ok ? Y + (size_t)cg * m + j : Y, ok);
    }
  } else if constexpr (VEC) {                       // bf16 rows, 4 columns a copy
    for (int e = threadIdx.x; e < KT * (kTS / 4); e += kThreads) {
      const int c = e / (kTS / 4), jj = (e % (kTS / 4)) * 4;
      const int j = j0 + jj, cg = c0 + c;
      const bool ok = j < j_end && cg < k;
      stream::cp_async8(ys + c * kPitch + ypos<TX>(jj), ok ? Y + (size_t)cg * m + j : Y, ok);
    }
  } else {                                          // scalar route: plain loads
    for (int e = threadIdx.x; e < KT * kTS; e += kThreads) {
      const int c = e / kTS, jj = e % kTS;
      const int j = j0 + jj, cg = c0 + c;
      ys[c * kPitch + ypos<TX>(jj)] = j < j_end && cg < k ? Y[(size_t)cg * m + j] : TY(0.f);
    }
  }
}

// One warp-step: acc[r][c] += Σ_t x[r][t] · y_c[t] over the lane's kVec
// columns, t ascending. yc points at the lane's first column (fp32 window)
// or the first of its first 4 (bf16 window) in row 0 of the step's Y tile.
template <typename TX, typename TY, int KT, int R, int PITCH>
__device__ __forceinline__ void cross_step(float (&acc)[R][KT], const uint4 (&x)[R],
                                           const TY* yc) {
  if constexpr (sizeof(TX) == 4) {        // 4 fp32 columns a lane, Y fp32
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      const float4 y = *reinterpret_cast<const float4*>(yc + c * PITCH);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][c] = fmaf(__uint_as_float(x[r].x), y.x, acc[r][c]);
        acc[r][c] = fmaf(__uint_as_float(x[r].y), y.y, acc[r][c]);
        acc[r][c] = fmaf(__uint_as_float(x[r].z), y.z, acc[r][c]);
        acc[r][c] = fmaf(__uint_as_float(x[r].w), y.w, acc[r][c]);
      }
    }
  } else {                                // 8 bf16 columns a lane, 4 at a time
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float xf[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t u0 = hh ? x[r].z : x[r].x, u1 = hh ? x[r].w : x[r].y;
        xf[r][0] = stream::lo(u0);
        xf[r][1] = stream::hi(u0);
        xf[r][2] = stream::lo(u1);
        xf[r][3] = stream::hi(u1);
      }
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        float y[4];
        if constexpr (sizeof(TY) == 4) {
          const float4 q = *reinterpret_cast<const float4*>(yc + c * PITCH + 128 * hh);
          y[0] = q.x, y[1] = q.y, y[2] = q.z, y[3] = q.w;
        } else {
          const uint2 q = *reinterpret_cast<const uint2*>(yc + c * PITCH + 128 * hh);
          y[0] = stream::lo(q.x), y[1] = stream::hi(q.x);
          y[2] = stream::lo(q.y), y[3] = stream::hi(q.y);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[r][c] = fmaf(xf[r][t], y[t], acc[r][c]);
      }
    }
  }
}

template <typename TX, typename TY, bool Y_KMAJOR, int KT, bool VEC>
__global__ void __launch_bounds__(CrossCfg<KT>::kThreads, 2)
cross_partial_kernel(const TX* __restrict__ X, int n_x, const TX* __restrict__ X2, int n_x2,
                     const TY* __restrict__ Y, int m, int k, int chunk,
                     float* __restrict__ part) {
  using Cfg = CrossCfg<KT>;
  constexpr int R = Cfg::kRows, S = Cfg::kSteps;
  constexpr int kVec = stream::Lane<TX>::kVec;
  constexpr int kTW = 32 * kVec;                    // columns a warp-step
  constexpr int kTS = cross_stage_cols<TX, KT>();   // columns a stage
  constexpr int kPitch = cross_pitch<TX, TY, KT>();
  extern __shared__ __align__(16) unsigned char cross_smem[];
  TY* ys = reinterpret_cast<TY*>(cross_smem);       // [2][KT][kPitch]

  const int rows = n_x + n_x2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * R;
  const int p = blockIdx.y;
  const int c0 = blockIdx.z * KT;
  const int j_begin = p * chunk;
  const int j_end = min(m, j_begin + chunk);
  const int stages = (j_end - j_begin + kTS - 1) / kTS;

  const TX* xrow[R];
  int xend[R];                                      // j_end, or 0 past the rows
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    xrow[r] = i >= rows ? X : (i < n_x ? X + (size_t)i * m : X2 + (size_t)(i - n_x) * m);
    xend[r] = i < rows ? j_end : 0;
  }

  float acc[R][KT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = 0.f;

  // a stage's window loads from column j0 (none where !live)
  auto load_stage = [&](uint4 (&x)[S][R], int j0, bool live) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = j0 + s * kTW + kVec * lane;
#pragma unroll
      for (int r = 0; r < R; ++r) x[s][r] = stream::load16<VEC>(xrow[r] + j, j, live ? xend[r] : 0);
    }
  };

  stage_y<TX, TY, Y_KMAJOR, KT, VEC>(ys, Y, m, k, c0, j_begin, j_end);
  stream::cp_async_commit();
  uint4 cur[S][R];
  load_stage(cur, j_begin, true);

  for (int st = 0; st < stages; ++st) {
    const int j0 = j_begin + st * kTS;
    // stage st's Y has landed, and every warp is done with the other buffer
    stream::cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < stages)
      stage_y<TX, TY, Y_KMAJOR, KT, VEC>(ys + ((st + 1) & 1) * KT * kPitch, Y, m, k, c0,
                                         j0 + kTS, j_end);
    stream::cp_async_commit();
    // the vector route issues the next stage's loads before this stage's
    // FMAs; the scalar route, whose loads take twice the registers in bf16,
    // after them
    uint4 nxt[S][R];
    if constexpr (VEC) load_stage(nxt, j0 + kTS, st + 1 < stages);
    // the lane's first column in this stage's tile
    const TY* yt = ys + (st & 1) * KT * kPitch + 4 * lane;
#pragma unroll
    for (int s = 0; s < S; ++s)
      cross_step<TX, TY, KT, R, kPitch>(acc, cur[s], yt + s * kTW);
    if constexpr (VEC) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int r = 0; r < R; ++r) cur[s][r] = nxt[s][r];
    } else {
      load_stage(cur, j0 + kTS, st + 1 < stages);
    }
  }

  // fixed butterfly order: lane 0's sum is the same on every run
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][c] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= rows) continue;
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (c0 + c < k) part[((size_t)p * rows + row0 + r) * k + c0 + c] = acc[r][c];
    }
  }
}

// The tensor-core route: a bf16 window on the vector route. Its fp32 FMAs
// bind before its bytes (k flop per byte), so the products run on
// mma.sync m16n8k16 (bf16 in, fp32 out): the window's tile and Y's go
// through a ring of shared memory by cp.async, a warp takes 2 of the
// stage's 16 steps of 16 columns for all 32 rows (two ldmatrix.x4 of the
// window a step), and V, fp32, is split on the fly into three bf16 terms
// (hi = V rounded, mid = V − hi rounded, lo = V − hi − mid: exact, since
// three 8-bit significands hold fp32's 24), three products a step, the
// smallest first. A split into two leaves V 2⁻¹⁸ of itself away, ≈ 3e-6
// of the largest output from the float64 product against ≈ 3e-7 for
// three: chip_smoke.py and the cuda tests hold the product within 1e-6
// of it (TC_TOL). The fold's rows are bf16 already, one product. Each
// stage's products start from zero and are added into fp32 sums on the
// CUDA cores (the tensor cores' fp32 sum is not rounded to nearest), and
// the 8 warps' sums are added in warp order, so a repeat is bit-identical.
namespace tc {

constexpr int kThreads = 256;
constexpr int kCols = 256;                  // columns a stage: 16 steps, 2 a warp
constexpr int kXPitch = kCols + 8;          // bf16: rows 528 B apart, ldmatrix conflict-free

template <typename TY, int NT>
struct Cfg {
  static constexpr int kYRows = 8 * NT;
  // Y's rows (the columns of V, or the fold rows): 264 elements, so a warp's
  // fragment reads fall on distinct banks
  static constexpr int kYPitch = kCols + 8;
  static constexpr int kXBytes = kRowsPerBlock * kXPitch * 2;
  static constexpr int kStageBytes = kXBytes + kYRows * kYPitch * static_cast<int>(sizeof(TY));
  static constexpr int kStages = 4 * kStageBytes <= 113 * 1024 ? 4 : 3;
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(stream::smem(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 → bf16x2 rounded to nearest (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(y), "f"(x));
  return r;
}

// v = t[0] + t[1] + t[2] exactly, each a bf16x2 rounded from the rest of v
__device__ __forceinline__ void split_bf16(float2 v, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = pack_bf16(v.x, v.y);
    v.x -= stream::lo(t[i]);
    v.y -= stream::hi(t[i]);
  }
}

template <typename TY, bool Y_KMAJOR, int NT>
__device__ __forceinline__ void stage(unsigned char* slot, const __nv_bfloat16* X, int n_x,
                                      const __nv_bfloat16* X2, int rows, int row_base,
                                      const TY* Y, int m, int k, int c0, int j0, int j_end) {
  using C = Cfg<TY, NT>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(slot);
  TY* ys = reinterpret_cast<TY*>(slot + C::kXBytes);
  for (int e = threadIdx.x; e < kRowsPerBlock * 32; e += kThreads) {
    const int r = e >> 5, jj = (e & 31) * 8;
    const int i = row_base + r, j = j0 + jj;
    const bool ok = i < rows && j < j_end;
    const __nv_bfloat16* src = i < n_x ? X + (size_t)i * m : X2 + (size_t)(i - n_x) * m;
    stream::cp_async16(xs + r * kXPitch + jj, ok ? src + j : X, ok);
  }
  if constexpr (Y_KMAJOR) {                 // the fold rows, bf16, 16 bytes a copy
    for (int e = threadIdx.x; e < C::kYRows * 32; e += kThreads) {
      const int c = e >> 5, jj = (e & 31) * 8;
      const int j = j0 + jj, cg = c0 + c;
      const bool ok = j < j_end && cg < k;
      stream::cp_async16(ys + c * C::kYPitch + jj, ok ? Y + (size_t)cg * m + j : Y, ok);
    }
  } else {                                  // V (m, k) fp32, transposed, 4 bytes a copy
    for (int e = threadIdx.x; e < C::kYRows * kCols; e += kThreads) {
      const int jj = e / C::kYRows, c = e % C::kYRows;
      const int j = j0 + jj, cg = c0 + c;
      const bool ok = j < j_end && cg < k;
      stream::cp_async4(ys + c * C::kYPitch + jj, ok ? Y + (size_t)j * k + cg : Y, ok);
    }
  }
}

template <typename TY, bool Y_KMAJOR, int NT>
__global__ void __launch_bounds__(kThreads, 2)
cross_mma_kernel(const __nv_bfloat16* __restrict__ X, int n_x,
                 const __nv_bfloat16* __restrict__ X2, int n_x2, const TY* __restrict__ Y,
                 int m, int k, int chunk, float* __restrict__ part) {
  using C = Cfg<TY, NT>;
  constexpr int NS = C::kStages;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int rows = n_x + n_x2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_base = blockIdx.x * kRowsPerBlock;
  const int p = blockIdx.y;
  const int c0 = blockIdx.z * C::kYRows;
  const int j_begin = p * chunk;
  const int j_end = min(m, j_begin + chunk);
  const int stages = (j_end - j_begin + kCols - 1) / kCols;
  auto slot = [&](int s) { return mma_smem + (s % NS) * C::kStageBytes; };
  auto load = [&](int s) {
    if (s < stages)
      stage<TY, Y_KMAJOR, NT>(slot(s), X, n_x, X2, rows, row_base, Y, m, k, c0,
                              j_begin + s * kCols, j_end);
    stream::cp_async_commit();              // a group a stage, empty past the last
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) load(s);
  for (int st = 0; st < stages; ++st) {
    // stage st has landed, and every warp is done with stage st − 1's slot
    stream::cp_async_wait<NS - 2>();
    __syncthreads();
    load(st + NS - 1);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(slot(st));
    const TY* ys = reinterpret_cast<const TY*>(slot(st) + C::kXBytes);
    float d[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = (warp + 8 * t) * 16;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], xs + (mt * 16 + (lane & 15)) * kXPitch + col + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const TY* yb = ys + (nt * 8 + (lane >> 2)) * C::kYPitch + col + 2 * (lane & 3);
        if constexpr (Y_KMAJOR) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(yb);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(yb + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(d[mt][nt], a[mt], b0, b1);
        } else {
          uint32_t b0[3], b1[3];
          split_bf16(*reinterpret_cast<const float2*>(yb), b0);
          split_bf16(*reinterpret_cast<const float2*>(yb + 8), b1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int t = 2; t >= 0; --t) mma_bf16(d[mt][nt], a[mt], b0[t], b1[t]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[mt][nt][i];
  }

  // the 8 warps' sums of each (row, column of Y), in warp order
  stream::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(mma_smem);       // [8][32][kYRows]
  const int g = lane >> 2, q = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = red + (warp * kRowsPerBlock + mt * 16 + g + 8 * h) * C::kYRows + nt * 8 + q;
        o[0] = acc[mt][nt][2 * h];
        o[1] = acc[mt][nt][2 * h + 1];
      }
  __syncthreads();
  for (int e = threadIdx.x; e < kRowsPerBlock * C::kYRows; e += kThreads) {
    const int r = e / C::kYRows, c = e % C::kYRows;
    float sum = red[e];
#pragma unroll
    for (int v = 1; v < 8; ++v) sum += red[v * kRowsPerBlock * C::kYRows + e];
    if (row_base + r < rows && c0 + c < k)
      part[((size_t)p * rows + row_base + r) * k + c0 + c] = sum;
  }
}

template <typename TY, bool Y_KMAJOR, int NT>
cudaError_t launch(const __nv_bfloat16* X, int n_x, const __nv_bfloat16* X2, int n_x2,
                   const TY* Y, int m, int k, int P, int chunk, float* part, cudaStream_t st) {
  auto kernel = cross_mma_kernel<TY, Y_KMAJOR, NT>;
  constexpr int smem = Cfg<TY, NT>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_x + n_x2 + kRowsPerBlock - 1) / kRowsPerBlock, P, (k + 8 * NT - 1) / (8 * NT));
  kernel<<<grid, kThreads, smem, st>>>(X, n_x, X2, n_x2, Y, m, k, chunk, part);
  return stream::counted(cudaGetLastError(), stream::kCrossTensorCores);
}

}  // namespace tc

// out[e] = sum_p part[p, e], p ascending: the fixed-order second pass.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int P,
                                       int count, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * count + e];
  out[e] = s;
}

template <typename TX, typename TY, bool Y_KMAJOR, int KT, bool VEC>
cudaError_t launch_cross_kt(const TX* X, int n_x, const TX* X2, int n_x2, const TY* Y, int m,
                            int k, int P, int chunk, float* part, cudaStream_t st) {
  auto kernel = cross_partial_kernel<TX, TY, Y_KMAJOR, KT, VEC>;
  constexpr int smem = cross_smem_bytes<TX, TY, KT>();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_x + n_x2 + kRowsPerBlock - 1) / kRowsPerBlock, P, (k + KT - 1) / KT);
  kernel<<<grid, CrossCfg<KT>::kThreads, smem, st>>>(X, n_x, X2, n_x2, Y, m, k, chunk, part);
  return stream::counted(cudaGetLastError(),
                         VEC ? stream::kCrossVector : stream::kCrossScalar);
}

// A bf16 window on the vector route at 8 or 16 right-hand sides a block
// takes the tensor cores (serve_solve.cross_tensor_cores); the rest the
// CUDA cores.
template <typename TX, typename TY, bool Y_KMAJOR, bool VEC>
cudaError_t launch_cross_route(const TX* X, int n_x, const TX* X2, int n_x2, const TY* Y,
                               int m, int k, int P, int chunk, float* part, cudaStream_t st) {
  constexpr bool kTensor = VEC && sizeof(TX) == 2;
  if (kTensor && k_tile(k) >= 8 && chunk % tc::kCols) return cudaErrorInvalidValue;
  switch (k_tile(k)) {
    case 1:
      return launch_cross_kt<TX, TY, Y_KMAJOR, 1, VEC>(X, n_x, X2, n_x2, Y, m, k, P, chunk,
                                                       part, st);
    case 4:
      return launch_cross_kt<TX, TY, Y_KMAJOR, 4, VEC>(X, n_x, X2, n_x2, Y, m, k, P, chunk,
                                                       part, st);
    case 8:
      if constexpr (kTensor)
        return tc::launch<TY, Y_KMAJOR, 1>(X, n_x, X2, n_x2, Y, m, k, P, chunk, part, st);
      else
        return launch_cross_kt<TX, TY, Y_KMAJOR, 8, VEC>(X, n_x, X2, n_x2, Y, m, k, P, chunk,
                                                         part, st);
    default:
      if constexpr (kTensor)
        return tc::launch<TY, Y_KMAJOR, 2>(X, n_x, X2, n_x2, Y, m, k, P, chunk, part, st);
      else
        return launch_cross_kt<TX, TY, Y_KMAJOR, 16, VEC>(X, n_x, X2, n_x2, Y, m, k, P, chunk,
                                                          part, st);
  }
}

// vec: the vector route, as serve_solve.stream_route chose it; refused
// (cudaErrorInvalidValue) where a row of X or X2, or k-major Y, is not
// 16-byte aligned.
template <typename TX, typename TY, bool Y_KMAJOR>
cudaError_t launch_cross(const TX* X, int n_x, const TX* X2, int n_x2, const TY* Y, int m,
                         int k, int P, int chunk, int vec, float* part, cudaStream_t st) {
  if (!vec)
    return launch_cross_route<TX, TY, Y_KMAJOR, false>(X, n_x, X2, n_x2, Y, m, k, P, chunk,
                                                       part, st);
  if (m % stream::Lane<TX>::kVec || !stream::aligned16(X) || !stream::aligned16(X2) ||
      (Y_KMAJOR && !stream::aligned16(Y)))
    return cudaErrorInvalidValue;
  return launch_cross_route<TX, TY, Y_KMAJOR, true>(X, n_x, X2, n_x2, Y, m, k, P, chunk, part,
                                                    st);
}

inline cudaError_t launch_reduce(const float* part, int P, int count, float* out,
                                 cudaStream_t st) {
  reduce_partials_kernel<<<(count + 255) / 256, 256, 0, st>>>(part, P, count, out);
  return cudaGetLastError();
}

}  // namespace repro
