// What every kernel library of the port shares: widening loads from the
// window's storage dtype, and the two C entries that ``_build.py`` binds in
// each library (error strings, device selection). Include it once per
// library, through the kernel headers or directly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Column tile of a multi-RHS pass: 1, 4, 8 or 16 right-hand sides per block.
inline int k_tile(int k) { return k <= 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : 16; }

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own (static) CUDA runtime, whose current device is
// not PyTorch's: the wrappers select the operands' device before a launch.
extern "C" int repro_set_device(int device) { return cudaSetDevice(device); }
