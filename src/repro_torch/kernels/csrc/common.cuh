// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is reached through a plain C entry point (extern "C"),
// compiled by nvcc for sm_90a into one shared library and called through
// ctypes from the Python wrappers (repro_torch/kernels/*/ops.py).  An entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() right after its launches (or a negative code for an
// argument combination it does not support), so the wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rk {

// The reference masks with a finite -1e30, never -inf: a fully masked row
// then stays finite instead of turning into NaN.
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python side (repro_torch.kernels.build)
enum DType : int { kF32 = 0, kBF16 = 1 };

// Negative return codes for arguments an entry point does not take.
enum ArgError : int {
  kBadDType = -1,
  kBadHeadDim = -2,
  kBadShape = -3,
  kNoDriverEntry = -4,   // the driver lacks cuTensorMapEncodeTiled
  kTensorMap = -5,       // cuTensorMapEncodeTiled refused a tensor map
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T, widened to floats: Vec<T>::N elements from a 16-byte
// aligned address in one load instruction.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Raise a kernel's dynamic shared-memory cap once, when it needs more than
// the default 48 KB.  Returns the CUDA error of the attribute call.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rk

extern "C" const char* repro_error_string(int code);
