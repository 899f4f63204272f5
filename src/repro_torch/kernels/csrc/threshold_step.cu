// threshold_step: the fused Alg. 3 test/Send step for the majority problem.
//
// Replaces the Pallas kernel threshold_step_kernel
// (src/repro/kernels/wheel/threshold_step.py:35) on the majority problem
// (payload width P = 2: ones, total; data width D = 1). Semantics: the
// plain version protocol.threshold_rules with Majority.test
// (repro_torch/engine/problems.py).
//
// Per peer: knowledge K = sum_v X_in[v] + [x, 1]; agreement A = X_in + X_out;
// margin m(p) = 2 p.ones - p.total; violation on direction v when m(A) and
// m(K - A) disagree in sign; output m(K) >= 0; Send payload K - X_in.
// int32 arithmetic wraps as the reference's int32 does (computed in
// uint32, compared signed).
//
// Bound on the H100: bytes (52 bytes in, 31 out per peer, ~30 integer
// operations). Design: one thread per peer, elementwise; each thread
// reads its 6-int in/out rows (24 contiguous bytes) once.
#include "common.cuh"

namespace {

__device__ __forceinline__ int32_t margin(uint32_t ones, uint32_t total) {
  return static_cast<int32_t>(2u * ones - total);
}

__global__ void majority_threshold_kernel(const int32_t* __restrict__ in_pay,
                                          const int32_t* __restrict__ out_pay,
                                          const int32_t* __restrict__ x,
                                          int64_t n, bool* __restrict__ viol,
                                          int32_t* __restrict__ out,
                                          int32_t* __restrict__ pay) {
  const int64_t i = rt::global_index();
  if (i >= n) return;
  uint32_t ip[6], op[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    ip[j] = static_cast<uint32_t>(in_pay[6 * i + j]);
    op[j] = static_cast<uint32_t>(out_pay[6 * i + j]);
  }
  const uint32_t k1 = ip[0] + ip[2] + ip[4] + static_cast<uint32_t>(x[i]);
  const uint32_t k2 = ip[1] + ip[3] + ip[5] + 1u;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const uint32_t a1 = ip[2 * v] + op[2 * v];
    const uint32_t a2 = ip[2 * v + 1] + op[2 * v + 1];
    const int32_t ta = margin(a1, a2);
    const int32_t tka = margin(k1 - a1, k2 - a2);
    viol[3 * i + v] = (ta >= 0 && tka < 0) || (ta < 0 && tka > 0);
    pay[6 * i + 2 * v] = static_cast<int32_t>(k1 - ip[2 * v]);
    pay[6 * i + 2 * v + 1] = static_cast<int32_t>(k2 - ip[2 * v + 1]);
  }
  out[i] = margin(k1, k2) >= 0 ? 1 : 0;
}

}  // namespace

RT_EXPORT int rt_threshold_step_majority(const void* in_pay,
                                         const void* out_pay, const void* x,
                                         int64_t n, void* viol, void* out,
                                         void* pay, void* stream) {
  if (n > 0) {
    majority_threshold_kernel<<<rt::blocks_for(n), rt::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in_pay),
        static_cast<const int32_t*>(out_pay), static_cast<const int32_t*>(x),
        n, static_cast<bool*>(viol), static_cast<int32_t*>(out),
        static_cast<int32_t*>(pay));
  }
  return static_cast<int>(cudaGetLastError());
}
