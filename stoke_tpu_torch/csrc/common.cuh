// Shared helpers of the port's attention kernels: element conversion and
// the masking sentinel the JAX reference uses (stoke_tpu/ops/flash_attention.py
// `_NEG_INF`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stoke {

//: score given to a masked position; p is forced to 0 for s <= kNegInf / 2
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
// round to nearest even, as torch's float -> bfloat16 cast
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace stoke
