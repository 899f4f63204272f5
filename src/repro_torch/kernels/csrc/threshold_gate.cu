// threshold_gate: error-feedback threshold compression of one tensor.
//
// Replaces the Pallas kernel threshold_gate_kernel
// (src/repro/kernels/threshold_gate/threshold_gate.py:36, body _tg_kernel
// :26). Semantics: the plain version threshold_gate_reference
// (repro_torch/kernels/threshold_gate/ref.py):
//   acc = float(g) + float(r); mask = |acc| >= tau;
//   send = mask ? acc : 0;  new_res = acc - send;  n = sum(mask)
// with send cast to g's type and new_res to r's (fp32 or bf16 each).
// The arithmetic is one add, one compare and one subtract, each rounded
// once as the plain version rounds it (no multiply, so nothing for nvcc
// to contract into an FMA): outputs equal the plain version exactly. The
// build does not flush subnormals (no -ftz / --use_fast_math), as the
// CPU and PyTorch's CUDA elementwise kernels do not.
//
// tau is a runtime argument. Unlike the Pallas kernel there is no padding
// (a grid-stride loop guards the ragged end), so no pad-lane correction
// of the count is needed for tau <= 0.
//
// Bound on the H100: bytes (fp32: 8 bytes in, 8 out per element; ~6
// operations). Design: grid-stride loop; each thread counts its own
// elements, the block sums the counts (warp shuffles, then shared
// memory) and adds them with one atomicAdd to a zeroed int32. Integer
// addition is order-free, so the count is deterministic.
#include "common.cuh"
#include "dtype.cuh"

namespace {

template <typename G, typename R>
__global__ void threshold_gate_kernel(const G* __restrict__ g,
                                      const R* __restrict__ r, int64_t n,
                                      float tau, G* __restrict__ send,
                                      R* __restrict__ new_res,
                                      int32_t* __restrict__ count) {
  __shared__ int32_t warp_counts[rt::kThreads / 32];
  int32_t mine = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = rt::global_index(); i < n; i += stride) {
    const float acc = __fadd_rn(rt::to_f32(g[i]), rt::to_f32(r[i]));
    const bool m = fabsf(acc) >= tau;
    const float s = m ? acc : 0.0f;
    send[i] = rt::from_f32<G>(s);
    new_res[i] = rt::from_f32<R>(__fsub_rn(acc, s));
    mine += m ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_down_sync(0xffffffffu, mine, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    int32_t c = lane < rt::kThreads / 32 ? warp_counts[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0 && c != 0) atomicAdd(count, c);
  }
}

template <typename G, typename R>
void launch(const void* g, const void* r, int64_t n, float tau, void* send,
            void* new_res, void* count, cudaStream_t stream) {
  // enough blocks to fill the card; each thread then strides
  const int64_t want = (n + rt::kThreads - 1) / rt::kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  threshold_gate_kernel<G, R><<<blocks, rt::kThreads, 0, stream>>>(
      static_cast<const G*>(g), static_cast<const R*>(r), n, tau,
      static_cast<G*>(send), static_cast<R*>(new_res),
      static_cast<int32_t*>(count));
}

}  // namespace

// g_bf16 / r_bf16: 1 when that operand (and its output) is bfloat16,
// 0 when float32. count must be a zeroed int32 on the device.
RT_EXPORT int rt_threshold_gate(const void* g, int g_bf16, const void* r,
                                int r_bf16, int64_t n, float tau, void* send,
                                void* new_res, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (g_bf16 && r_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(g, r, n, tau, send, new_res, count, s);
    else if (g_bf16)
      launch<__nv_bfloat16, float>(g, r, n, tau, send, new_res, count, s);
    else if (r_bf16)
      launch<float, __nv_bfloat16>(g, r, n, tau, send, new_res, count, s);
    else
      launch<float, float>(g, r, n, tau, send, new_res, count, s);
  }
  return static_cast<int>(cudaGetLastError());
}
