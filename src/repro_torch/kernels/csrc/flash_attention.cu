// flash_attention: causal / sliding-window / bidirectional GQA attention
// forward with an online softmax,
//
//   s = (q · kᵀ) · scale,   masked scores → NEG = −0.7 · FLT_MAX,
//   m, l running max and sum (fp32),  p = exp(s − m) rounded to v's dtype,
//   o = (Σ p · v) / max(l, 1e-30)  in q's dtype.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel). On the TPU the grid's KV axis runs in order on one core
// and the (bq, hd) accumulator and the (bq,) statistics persist in VMEM
// scratch across it. Here one block owns one (batch·head, q tile) and
// walks the KV tiles itself, in ascending order, so a repeat is
// bit-identical; the accumulator and statistics live in registers.
//
// Layout: the model's, q (B, Tq, H, hd) and k, v (B, Tk, KH, hd), read in
// place — query head h reads KV head h / (H / KH), and K/V are never
// repeated in memory. Ragged Tq and Tk are masked here (rows past Tq are
// not written, keys past Tk never score), so the caller pads nothing.
// KV tiles wholly above the causal diagonal or outside the window are
// skipped, as the TPU kernel's pl.when does. A masked key contributes
// p = 0 (the TPU kernel's exp(NEG − m) is 0 too once a row has seen a live
// key), so a row with no live key at all gives l = 0 and an output of 0.
//
// Bound: operations (4·hd flop per live (q, k) pair; ≈ 200 flop per byte
// read at 32k tokens), at 989 TFLOP/s for bf16 operands. Three kernels:
// * bf16 at hd 64 and 128 (the LM's head dims): flash_wgmma_kernel
//   (flash_wgmma.cuh) — wgmma fed by TMA, one producer warp and two
//   consumer warpgroups a 128-row q tile, 128-key tiles in a ring of two;
//   its note says what it does about the bound;
// * bf16 at hd 16 and 32: flash_mma_kernel (below), mma.sync m16n8k16
//   with fp32 sums, 64-row q tiles and 64-key tiles loaded synchronously;
// * fp32, and bf16 at hd 256, run the products as fp32 FMAs on the CUDA
//   cores (flash_fwd_kernel): tiles widened to fp32 in shared memory, each
//   of 256 threads owning a 4 × 4 patch of the 64 × 64 score tile and a
//   4 × (hd/16) patch of the accumulator, row statistics reduced across
//   the 16 lanes of a half-warp.
#include "common.cuh"
#include "flash_wgmma.cuh"

#include <cstdint>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPad = 4;          // floats of row padding (bank spread, float4 aligned)
constexpr float kNeg = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// p rounded to v's dtype before P·V, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_like(float p, const float*) { return p; }
__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows x HD tile of a (B, T, heads, HD) tensor into fp32 shared memory with
// row stride `ld`; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int t0, int T_,
                                          int heads, int head, int b, int rows) {
  constexpr int kV = HD / 4;
  for (int e = threadIdx.x; e < rows * kV; e += kThreads) {
    const int r = e / kV, d = (e % kV) * 4, t = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T_) x = load4(src + (((size_t)b * T_ + t) * heads + head) * HD + d);
    *reinterpret_cast<float4*>(dst + r * ld + d) = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KH, int Tq, int Tk, float scale, int causal,
                 int window) {
  constexpr int DPT = HD / 16;                 // accumulator columns per thread
  constexpr int VW = DPT < 4 ? DPT : 4;        // their vector width
  constexpr int LDQ = HD + kPad, LDP = kBK + kPad;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][LDQ]
  float* ks = qs + kBQ * LDQ;                   // [kBK][LDQ]
  float* vs = ks + kBK * LDQ;                   // [kBK][HD]
  float* ps = vs + kBK * HD;                    // [kBQ][LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / (H / KH);
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q_hi = min(q0 + kBQ, Tq) - 1;

  load_tile<T, HD>(qs, LDQ, q, q0, Tq, H, h, b, kBQ);

  float acc[4][DPT], m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNeg;
    l_i[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DPT; ++u) acc[i][u] = 0.f;
  }

  const int nk = (Tk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // a KV tile is live unless it lies wholly above the causal diagonal or
    // wholly outside the window of every row of this q tile
    if (causal && k0 > q_hi) break;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;

    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile<T, HD>(ks, LDQ, k, k0, Tk, KH, kh, b, kBK);
    load_tile<T, HD>(vs, HD, v, k0, Tk, KH, kh, b, kBK);
    __syncthreads();

    // s = q·kᵀ for rows 4ty..4ty+3, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, online softmax; a row's 64 scores live on the 16 lanes of a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool live[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        live[j] = kp < Tk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = live[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(4 * ty + i) * LDP + tx + 16 * j] = round_like(p, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = corr * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int u = 0; u < DPT; ++u) acc[i][u] *= corr;
    }
    __syncthreads();

    // acc += P·V over the tile's keys in ascending order
#pragma unroll 2
    for (int s0 = 0; s0 < kBK; s0 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * LDP + s0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (s0 + e) * HD;
        float vv[DPT];
#pragma unroll
        for (int u = 0; u < DPT; u += VW) {
          const int col = 16 * VW * (u / VW) + VW * tx;
          if constexpr (VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + col);
            vv[u] = t.x; vv[u + 1] = t.y; vv[u + 2] = t.z; vv[u + 3] = t.w;
          } else if constexpr (VW == 2) {
            const float2 t = *reinterpret_cast<const float2*>(vrow + col);
            vv[u] = t.x; vv[u + 1] = t.y;
          } else {
            vv[u] = vrow[col];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int u = 0; u < DPT; ++u) acc[i][u] = fmaf(p, vv[u], acc[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= Tq) continue;
    const float inv_l = 1.f / fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((size_t)b * Tq + t) * H + h) * HD;
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int col = 16 * VW * (u / VW) + VW * tx + u % VW;
      store1(orow + col, acc[i][u] * inv_l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 16 and 32 on mma.sync m16n8k16 (bf16 operands, fp32 sums).
// 4 warps, each owning 16 of the tile's 64 q rows; the warp's Q fragments
// stay in registers for the whole KV sweep. Per KV tile: S = Q·Kᵀ as 8
// n-tiles of 8 keys (HD/16 MMAs each), the online softmax on the MMA's
// accumulator layout (a row's 16 scores a thread, the row spread over a
// quad of lanes), then P — rounded to bf16, v's dtype, in the A-fragment
// layout the accumulator already has — times V. K/V tiles are bf16 in
// shared memory with rows padded by 16 bytes (conflict-free fragment reads).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// rows x HD bf16 tile of a (B, T, heads, HD) tensor into shared memory
// (row stride LD elements); rows at or past T are zero.
template <int HD, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int t0, int T_, int heads, int head, int b) {
  constexpr int kC = HD / 8;   // 16-byte chunks a row
  for (int e = threadIdx.x; e < 64 * kC; e += kMmaThreads) {
    const int r = e / kC, c = (e % kC) * 8, t = t0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_) x = *reinterpret_cast<const uint4*>(src + (((size_t)b * T_ + t) * heads + head) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                 int KH, int Tq, int Tk, float scale, int causal, int window) {
  constexpr int LD = HD + 8;
  constexpr int KS = HD / 16;   // k-steps of Q·Kᵀ
  constexpr int NO = HD / 8;    // n-tiles of the output
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);   // [64][LD]
  __nv_bfloat16* ks = qs + kBQ * LD;                                // [64][LD]
  __nv_bfloat16* vs = ks + kBK * LD;                                // [64][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q_hi = min(q0 + kBQ, Tq) - 1;
  const int qp0 = q0 + 16 * warp + g, qp1 = qp0 + 8;   // this thread's two rows

  load_tile_bf16<HD, LD>(qs, q, q0, Tq, H, h, b);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* base = qs + (16 * warp) * LD + 16 * kk + 2 * t4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + g * LD);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + g * LD + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * LD + 8);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};   // l: this thread's part of the row sum

  const int nk = (Tk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q_hi) break;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;

    __syncthreads();
    load_tile_bf16<HD, LD>(ks, k, k0, Tk, KH, kh, b);
    load_tile_bf16<HD, LD>(vs, v, k0, Tk, KH, kh, b);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = ks + (8 * j + g) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(krow + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8));
    }

    // mask and scale; element e of n-tile j: row e < 2 ? qp0 : qp1, key
    // 8j + 2t4 + (e & 1); bit 4j + e of `live` marks a live key
    uint32_t live = 0u;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = e < 2 ? qp0 : qp1, kp = k0 + 8 * j + 2 * t4 + (e & 1);
        if (kp < Tk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)) {
          live |= 1u << (4 * j + e);
          s[j][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (4 * j + e)) & 1u ? expf(s[j][e] - m_r[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // acc += P·V, keys in 4 k-steps of 16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v0 = vs + (16 * kk + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vc = v0 + 8 * n;
        mma_bf16(acc[n], pa, pack_raw(vc, vc + LD), pack_raw(vc + 8 * LD, vc + 9 * LD));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r ? qp1 : qp0;
    if (t >= Tq) continue;
    __nv_bfloat16* orow = o + (((size_t)b * Tq + t) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
               int Tq, int Tk, float scale, int causal, int window, cudaStream_t st) {
  constexpr int smem = 3 * 64 * (HD + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_mma_kernel<HD><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, KH, Tq, Tk,
      scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * (HD + kPad) + kBK * (HD + kPad) + kBK * HD + kBQ * (kBK + kPad)) * 4;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int Tq,
           int Tk, float scale, int causal, int window, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KH, Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
             int Tq, int Tk, int hd, float scale, int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Tq, H, hd); k, v: (B, Tk, KH, hd); one dtype, fp32 or bf16 (bf16 != 0).
// window <= 0: no sliding window. hd in {16, 32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bf16, int B, int H, int KH, int Tq, int Tk, int hd,
                                      float scale, int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || KH < 1 || H % KH || Tq < 1 || Tk < 1 || B * H > 65535)
    return cudaErrorInvalidValue;
  if (bf16) {   // wgmma at hd 64 and 128, mma.sync at 16 and 32, the CUDA cores at 256
    switch (hd) {
      case 16: return launch_mma<16>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
      case 32: return launch_mma<32>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
      case 64: return fa3::launch<64>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
      case 128: return fa3::launch<128>(q, k, v, o, B, H, KH, Tq, Tk, scale, causal, window, st);
      default: return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, Tq, Tk, hd, scale, causal, window, st);
    }
  }
  return dispatch<float>(q, k, v, o, B, H, KH, Tq, Tk, hd, scale, causal, window, st);
}
