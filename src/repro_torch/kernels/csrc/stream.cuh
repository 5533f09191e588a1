// What the two streaming passes over the window (cross.cuh, apply.cuh) share:
// a lane's 16-byte load of a window row, its widening to fp32, and cp.async
// with zero fill.
//
// Routes. An aligned window — every row starting on a 16-byte boundary, that
// is m·sizeof(T) a multiple of 16 and the data 16-byte aligned — is read with
// one ld.global.nc.L1::no_allocate.v4 a lane (the window streams past L1);
// any other window with kVec scalar loads a lane. The Python rule
// ``serve_solve.stream_route`` chooses. On the CUDA cores both routes give a
// lane the same columns, so they add in the same order and give the same
// bits. The exception: a bf16 window's cross pass at 8 or 16 right-hand
// sides a block runs on the tensor cores on the vector route only
// (cross.cuh), so there the same values at an unaligned offset, read by the
// scalar route on the CUDA cores, give other bits.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace repro {
namespace stream {

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

// columns j … j + kVec − 1 of the row at p (p points at column j), raw; zero
// bits at and past `end`. On the vector route end is a multiple of kVec, so
// the 16 bytes are all in or all out.
template <bool VEC, typename T>
__device__ __forceinline__ uint4 load16(const T* p, int j, int end) {
  using L = Lane<T>;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (j < end)
      asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
          : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
          : "l"(p));
    return r;
  }
  typename L::Bits e[L::kVec];
  const typename L::Bits* q = reinterpret_cast<const typename L::Bits*>(p);
#pragma unroll
  for (int c = 0; c < L::kVec; ++c) e[c] = j + c < end ? q[c] : 0;
  memcpy(&r, e, sizeof(r));
  return r;
}

// a word of two bf16 columns widened: the element's bits in the top half
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4, 8 or 16 bytes global → shared; zeros where !valid (src is then not
// read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T>
inline bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches of each streaming kernel, counted on the host where the kernel is
// launched (cross.cuh, apply.cuh), so that a caller can read which kernels a
// call ran (serve_solve.kernels_launched in Python), beside the route the
// Python rule chose. Mirrored by serve_solve.STREAM_KERNELS. The counts are
// static, one set a library: an inline (extern) array would be one symbol
// that every loaded library shares.
enum Kernel {
  kCrossScalar,
  kCrossVector,
  kCrossTensorCores,
  kApplyScalar,
  kApplyVector,
  kKernels
};
static std::atomic<long long> launched[kKernels];

// counts a launch of `which` that the runtime accepted; passes err on
static inline cudaError_t counted(cudaError_t err, Kernel which) {
  if (err == cudaSuccess) launched[which].fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace stream
}  // namespace repro

// out[i]: the launches of streaming kernel i (repro::stream::Kernel) by this
// library so far.
extern "C" int repro_stream_launches(long long* out) {
  for (int i = 0; i < repro::stream::kKernels; ++i) out[i] = repro::stream::launched[i].load();
  return 0;
}
