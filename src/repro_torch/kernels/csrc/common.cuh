// Shared launch helpers for the port's wheel kernels (plain C interface,
// bound from Python with ctypes; no PyTorch headers).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

namespace rt {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n, int threads = kThreads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

__device__ __forceinline__ int64_t global_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

}  // namespace rt
