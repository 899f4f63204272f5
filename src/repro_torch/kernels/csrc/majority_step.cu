// majority_step: the fused Alg. 3 majority step on (N, 3) counter planes.
//
// Replaces the Pallas kernel majority_step_kernel
// (src/repro/kernels/majority_step/majority_step.py:45). Semantics: the
// plain version protocol.majority_rules (repro_torch/engine/protocol.py).
// The Pallas kernel transposes the planes to (3, N), direction-major, to
// fill the TPU's 128 lanes; here the planes keep the function's (N, 3)
// layout and each thread takes one peer.
//
// Per peer: K = (sum_v ones_in[v] + x, sum_v tot_in[v] + 1); A = X_in +
// X_out per direction; violation when 2 ones - total of A and of K - A
// disagree in sign; output 2 K.ones - K.total >= 0; Send payload K - X_in.
// int32 arithmetic wraps as the reference's does (computed in uint32,
// compared signed).
//
// Bound on the H100: bytes (52 bytes in, 31 out per peer, ~30 integer
// operations). Design: one thread per peer; each thread reads its four
// 12-byte plane rows and its vote once.
#include "common.cuh"

namespace {

__device__ __forceinline__ int32_t thr2(uint32_t ones, uint32_t total) {
  return static_cast<int32_t>(2u * ones - total);
}

__global__ void majority_step_kernel(const int32_t* __restrict__ in_ones,
                                     const int32_t* __restrict__ in_tot,
                                     const int32_t* __restrict__ out_ones,
                                     const int32_t* __restrict__ out_tot,
                                     const int32_t* __restrict__ x, int64_t n,
                                     bool* __restrict__ viol,
                                     int32_t* __restrict__ out,
                                     int32_t* __restrict__ pay_ones,
                                     int32_t* __restrict__ pay_tot) {
  const int64_t i = rt::global_index();
  if (i >= n) return;
  uint32_t io[3], it[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    io[v] = static_cast<uint32_t>(in_ones[3 * i + v]);
    it[v] = static_cast<uint32_t>(in_tot[3 * i + v]);
  }
  const uint32_t k_ones = io[0] + io[1] + io[2] + static_cast<uint32_t>(x[i]);
  const uint32_t k_tot = it[0] + it[1] + it[2] + 1u;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const uint32_t a_ones = io[v] + static_cast<uint32_t>(out_ones[3 * i + v]);
    const uint32_t a_tot = it[v] + static_cast<uint32_t>(out_tot[3 * i + v]);
    const int32_t ta = thr2(a_ones, a_tot);
    const int32_t tka = thr2(k_ones - a_ones, k_tot - a_tot);
    viol[3 * i + v] = (ta >= 0 && tka < 0) || (ta < 0 && tka > 0);
    pay_ones[3 * i + v] = static_cast<int32_t>(k_ones - io[v]);
    pay_tot[3 * i + v] = static_cast<int32_t>(k_tot - it[v]);
  }
  out[i] = thr2(k_ones, k_tot) >= 0 ? 1 : 0;
}

}  // namespace

RT_EXPORT int rt_majority_step(const void* in_ones, const void* in_tot,
                               const void* out_ones, const void* out_tot,
                               const void* x, int64_t n, void* viol, void* out,
                               void* pay_ones, void* pay_tot, void* stream) {
  if (n > 0) {
    majority_step_kernel<<<rt::blocks_for(n), rt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in_ones),
        static_cast<const int32_t*>(in_tot),
        static_cast<const int32_t*>(out_ones),
        static_cast<const int32_t*>(out_tot), static_cast<const int32_t*>(x),
        n, static_cast<bool*>(viol), static_cast<int32_t*>(out),
        static_cast<int32_t*>(pay_ones), static_cast<int32_t*>(pay_tot));
  }
  return static_cast<int>(cudaGetLastError());
}
