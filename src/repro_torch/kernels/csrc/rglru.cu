// rglru_scan: the RG-LRU diagonal linear recurrence h_t = a_t h_{t-1} + u_t.
//
// Replaces the Pallas kernel rglru_scan (src/repro/kernels/rglru/rglru.py:56,
// body _rglru_kernel :32). Semantics: the plain version
// linear_scan_reference (repro_torch/kernels/rglru/ref.py): (B, T, W)
// inputs a and u, optional h0 (B, W); returns h (B, T, W) and h_T (B, W)
// in the inputs' type (float32 or bfloat16), with the state in float32.
// The backward of the scan (repro_torch/kernels/rglru/ops.py) runs this
// same kernel on time-reversed inputs.
//
// The Pallas kernel tiles (B, W/128, T/256) with time innermost and the
// state in VMEM scratch, streaming (a, u) once and h once. Here each
// thread owns one (b, w) channel and loops over T with the state in a
// register; neighbouring threads take neighbouring w, so every load and
// store of a time step is coalesced. Loads run PREFETCH steps ahead of
// the dependent multiply-add chain.
//
// Bound on the H100: bytes (2 reads and 1 write of the input type per
// element, 2 flops). At B = 1, W = 4096 the card holds only 4096 threads
// (64 blocks of 64): too few to cover memory latency, so this kernel runs
// well above its bound; raising occupancy (a chunked two-pass scan over T)
// is later work.
#include "common.cuh"
#include "dtype.cuh"

namespace {

constexpr int kScanThreads = 64;
constexpr int kPrefetch = 8;

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  const T* __restrict__ h0, int64_t batch, int64_t steps,
                  int64_t width, T* __restrict__ h, T* __restrict__ h_last) {
  const int64_t ch = rt::global_index();
  if (ch >= batch * width) return;
  const int64_t b = ch / width, w = ch % width;
  const int64_t base = b * steps * width + w;
  float state = h0 != nullptr ? rt::to_f32(h0[ch]) : 0.0f;
  int64_t t = 0;
  for (; t + kPrefetch <= steps; t += kPrefetch) {
    float av[kPrefetch], uv[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      av[i] = rt::to_f32(a[base + (t + i) * width]);
      uv[i] = rt::to_f32(u[base + (t + i) * width]);
    }
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      state = av[i] * state + uv[i];
      h[base + (t + i) * width] = rt::from_f32<T>(state);
    }
  }
  for (; t < steps; ++t) {
    state = rt::to_f32(a[base + t * width]) * state +
            rt::to_f32(u[base + t * width]);
    h[base + t * width] = rt::from_f32<T>(state);
  }
  h_last[ch] = rt::from_f32<T>(state);
}

template <typename T>
void launch(const void* a, const void* u, const void* h0, int64_t batch,
            int64_t steps, int64_t width, void* h, void* h_last,
            cudaStream_t stream) {
  rglru_scan_kernel<T>
      <<<rt::blocks_for(batch * width, kScanThreads), kScanThreads, 0,
         stream>>>(static_cast<const T*>(a), static_cast<const T*>(u),
                   static_cast<const T*>(h0), batch, steps, width,
                   static_cast<T*>(h), static_cast<T*>(h_last));
}

}  // namespace

// bf16: 1 when a, u, h0, h and h_last are bfloat16, 0 when float32.
// h0 may be null (a zero initial state).
RT_EXPORT int rt_rglru_scan(const void* a, const void* u, const void* h0,
                            int bf16, int64_t batch, int64_t steps,
                            int64_t width, void* h, void* h_last,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * width > 0) {
    if (bf16)
      launch<__nv_bfloat16>(a, u, h0, batch, steps, width, h, h_last, s);
    else
      launch<float>(a, u, h0, batch, steps, width, h, h_last, s);
  }
  return static_cast<int>(cudaGetLastError());
}
