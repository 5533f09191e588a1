// flash_wgmma: the bf16 flash-attention forward at hd 64 and 128 on Hopper's
// wgmma, fed by TMA (included by flash_attention.cu, whose C entry routes bf16
// at those head dims here).
//
// Computes what flash_mma_kernel and the TPU kernel
// (src/repro/kernels/flash_attention.py:flash_attention_pallas) compute:
// s = q·kᵀ·scale, masked keys p = 0 (causal, window, bidirectional, ragged
// Tq/Tk), m and l in fp32 with l summing the unrounded p, p rounded to bf16
// before P·V, o = acc / max(l, 1e-30) in bf16, a row with no live key 0.
//
// Bound: operations — 4·hd flop per live (q, k) pair at 989 TFLOP/s dense
// bf16 (6.67 ms at (1, 32768, 24/8, 128) causal; the bytes, 0.16 ms, are
// far below). The mma.sync kernel it replaces reached 125 TFLOP/s: mma.sync
// cannot issue at Hopper's tensor rate, its tile loads were synchronous (two
// __syncthreads a KV tile, no overlap with the math), V's fragments came
// from scalar 16-bit shared loads, and every tile paid the mask. Here:
//
// * Block: 3 warpgroups. WG 2 is the producer (one thread issues TMA; its
//   registers drop to 24 by setmaxnreg), WG 0 and 1 the consumers (240
//   registers), each owning 64 of the block's 128 q rows of one (batch,
//   head). Blocks are 1-D: per (batch, head) the q tiles longest-first,
//   so a wave holds one head's tiles and shares its K/V in L2.
// * TMA: 4-D tensor maps over (hd, heads, T, B) — the model layout in
//   place, GQA by the KV head coordinate, no repeated K/V. A box past Tq
//   or Tk fills with zeros instead of reading the next batch's rows (the
//   zero keys are still masked: a zero key scores 0, not −∞). 128-byte
//   swizzle, so an hd-128 bf16 row is two 64-column boxes ("panels"). Q
//   arrives once; K and V of 128-key tiles in a ring of two stages, each
//   with its own full barrier (S can start before V lands) and one empty
//   barrier that the 8 consumer warps release.
// * S = Q·Kᵀ: wgmma m64n128k16, both operands K-major in shared memory;
//   the descriptors step 32 bytes inside a swizzled 128-byte row and one
//   panel (rows × 128 bytes) per 64 columns of hd.
// * O += P·V: wgmma with A in registers — P packed from S's accumulator
//   layout into bf16 A fragments (the TPU kernel's p.astype(v.dtype)) —
//   and V (keys × hd, hd contiguous) as an MN-major B operand (transpose
//   bit): LBO steps 64 hd columns (one panel), SBO 8 keys.
// * Softmax in registers, fp32: t = s·c with c = scale·log2 e (the scale
//   after q·kᵀ, any sign), the row max m of t, p = 2^(t − m); masked
//   scores are −∞ (p = 0 exactly) while m starts at a finite −0.7·FLT_MAX,
//   so no row ever forms ∞ − ∞ and a row with no live key keeps l = 0.
// * The mask runs only on tiles that cross Tk, the causal diagonal or the
//   window's edge (per warpgroup); interior tiles skip it, and tiles wholly
//   above the diagonal or outside the window are never loaded.
// * KV tiles are walked in ascending order per q tile: no split-KV, no
//   float atomics, so a repeat is bit-identical.
#pragma once

#include "hopper.cuh"

namespace fa3 {

using namespace hopper;

constexpr int kBM = 128;          // q rows a block: two consumer warpgroups of 64
constexpr int kBN = 128;          // keys a KV tile
constexpr int kStages = 2;        // K/V ring
constexpr int kThreads = 384;     // WG 0, 1: consumers; WG 2: producer
constexpr int kEmptyArrivals = 8; // consumer warps
constexpr float kMInit = -0.7f * 3.402823466e38f;
static_assert(kBM == kBN, "Q and K panels share one descriptor step");

template <int HD>
struct Layout {
  static constexpr int kPanels = HD / 64;               // 64-column (128-byte) panels
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int kBytes = kBar + 64 + 1024;       // + room to align the base to 1024
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// D (64 x 128, fp32) += A·B, A bf16 in registers (the m16n8k16 A-fragment
// layout per warp), B bf16 in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A·B, A bf16 in registers (the m16n8k16 A-fragment
// layout per warp), B bf16 in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                   int KH, int Tq, int Tk, int n_qtiles, float scale_log2, int causal,
                   int window) {
  using Lay = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Lay::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int tile = blockIdx.x % n_qtiles, bh = blockIdx.x / n_qtiles;
  const int b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = (n_qtiles - 1 - tile) * kBM;   // longest q tiles first
  const int q_hi = min(q0 + kBM, Tq) - 1;
  // the KV tiles any row of the block sees: none above the diagonal, none
  // wholly outside the window
  const int nk = (Tk + kBN - 1) / kBN;
  const int kt_end = causal ? min(nk, q_hi / kBN + 1) : nk;
  const int kt_begin = window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / kBN : 0;
  const int n_iter = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Lay::kQBytes);
#pragma unroll
      for (int c = 0; c < Lay::kPanels; ++c)
        tma_load(smem + Lay::kQ + c * kBM * 128, &tq, q_full, 64 * c, h, q0, b);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (kt_begin + it) * kBN;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, Lay::kKVBytes);
#pragma unroll
        for (int c = 0; c < Lay::kPanels; ++c)
          tma_load(smem + Lay::kK + s * Lay::kKVBytes + c * kBN * 128, &tk, k_full + s, 64 * c,
                   kh, k0, b);
        mbar_expect_tx(v_full + s, Lay::kKVBytes);
#pragma unroll
        for (int c = 0; c < Lay::kPanels; ++c)
          tma_load(smem + Lay::kV + s * Lay::kKVBytes + c * kBN * 128, &tv, v_full + s, 64 * c,
                   kh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;   // this warpgroup's rows
    const int row0 = r_lo + 16 * warp + g;              // this thread's rows: row0, row0 + 8
    const uint32_t q_base = smem_u32(smem + Lay::kQ) + wg * 64 * 128;

    float oacc[HD / 2], sacc[64];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
    float m_r[2] = {kMInit, kMInit};   // row max of the scaled scores
    float l_r[2] = {0.f, 0.f};         // this thread's part of the row sum

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (kt_begin + it) * kBN;

      // S = Q·Kᵀ (64 x 128), hd in steps of 16
      mbar_wait(k_full + s, ph);
      const uint32_t k_base = smem_u32(smem + Lay::kK + s * Lay::kKVBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBM * 128 + (kk % 4) * 32;   // panel, 32 B a step
        wgmma_ss_n128(sacc, desc_sw128(q_base + off, 16, 1024),
                      desc_sw128(k_base + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // scale (log2 units), and mask only where the tile crosses Tk, the
      // diagonal or the window edge
#pragma unroll
      for (int i = 0; i < 64; ++i) sacc[i] *= scale_log2;
      const bool edge = k0 + kBN > Tk || (causal && k0 + kBN - 1 > r_lo) ||
                        (window > 0 && k0 <= r_hi - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = row0 + 8 * (e >> 1), kp = k0 + 8 * j + 2 * t4 + (e & 1);
            if (!(kp < Tk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)))
              sacc[4 * j + e] = __uint_as_float(0xff800000u);   // −∞
          }
      }

      // online softmax on the accumulator layout: element 4j + e is row
      // row0 + 8·(e >> 1), key k0 + 8j + 2·t4 + (e & 1); a row spans a quad
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= corr[r];
      }
      uint32_t pa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(sacc[4 * j + e] - mx[e >> 1]);
          l_r[e >> 1] += p[e];
        }
        // keys 16kk..16kk+15 are n-chunks 2kk (a0, a1) and 2kk + 1 (a2, a3)
        pa[j / 2][2 * (j % 2)] = pack_bf16x2(p[0], p[1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16x2(p[2], p[3]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        oacc[4 * n] *= corr[0];
        oacc[4 * n + 1] *= corr[0];
        oacc[4 * n + 2] *= corr[1];
        oacc[4 * n + 3] *= corr[1];
      }

      // O += P·V, keys in steps of 16 (two 8-key swizzle rows of 1024 B)
      mbar_wait(v_full + s, ph);
      const uint32_t v_base = smem_u32(smem + Lay::kV + s * Lay::kKVBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<HD>(oacc, pa[kk], desc_sw128(v_base + kk * 2048, kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(empty + s);
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
      const int t = row0 + 8 * r;
      if (t >= Tq) continue;
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Tq + t) * H + h) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16x2(oacc[4 * n + 2 * r] * inv[r], oacc[4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// (B, T, heads, hd) bf16, contiguous: boxes of 64 hd columns × `rows` of T
inline bool make_map(CUtensorMap* map, const void* base, int B, int T, int heads, int hd,
                     int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)T * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int Tq,
           int Tk, float scale, int causal, int window, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Tq, H, HD, kBM) || !make_map(&tk, k, B, Tk, KH, HD, kBN) ||
      !make_map(&tv, v, B, Tk, KH, HD, kBN))
    return cudaErrorInvalidValue;
  const int n_qtiles = (Tq + kBM - 1) / kBM;
  if ((long long)n_qtiles * B * H >= (1ll << 31)) return cudaErrorInvalidValue;
  constexpr int smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<HD><<<n_qtiles * B * H, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KH, Tq, Tk, n_qtiles,
      scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace fa3
