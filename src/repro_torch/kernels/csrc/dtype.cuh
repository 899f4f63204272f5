// float32 / bfloat16 loads and stores for the training substrate's
// kernels: arithmetic is in float32, stores round to nearest even as
// PyTorch's `.to(torch.bfloat16)` does.
#pragma once
#include <cuda_bf16.h>

namespace rt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace rt
