// stage_rows: stamp the DELIVER_T column of the cycle's staged wheel rows.
//
// Replaces the Pallas kernel stage_rows_kernel
// (src/repro/kernels/wheel/enqueue.py:52). Semantics: the plain version
// stage_rows_reference in repro_torch/kernels/wheel/enqueue.py.
//
// Bound on the H100: bytes. Each row is copied once and one column is
// replaced; there is no arithmetic to speak of. Design: one thread per
// int64 element of the row-major (M, ROWW) block, so a warp reads and
// writes 256 contiguous bytes; the thread that owns a row's DELIVER_T
// element computes the stamp (the 10-entry perm is read through L1).
#include "common.cuh"

namespace {

__global__ void stage_rows_kernel(const int64_t* __restrict__ rows,
                                  const bool* __restrict__ alert,
                                  const int64_t* __restrict__ ordinal,
                                  const int32_t* __restrict__ perm,
                                  uint32_t t, int64_t total, int roww,
                                  int dt_col, int64_t* __restrict__ out) {
  const int64_t i = rt::global_index();
  if (i >= total) return;
  const int64_t r = i / roww;
  const int c = static_cast<int>(i - r * roww);
  if (c != dt_col) {
    out[i] = rows[i];
    return;
  }
  // floor mod: C++ % truncates, and a leading dead row's ordinal -1
  // must read delay class 9
  const int cls = static_cast<int>(((ordinal[r] % 10) + 10) % 10);
  const uint32_t delay = alert[r] ? 1u : static_cast<uint32_t>(perm[cls]);
  out[i] = static_cast<int64_t>(static_cast<uint32_t>(t + delay));  // wraps at 32 bits
}

}  // namespace

RT_EXPORT int rt_stage_rows(const void* rows, const void* alert,
                            const void* ordinal, const void* perm, int64_t t,
                            int64_t m, int32_t roww, int32_t dt_col,
                            void* out, void* stream) {
  const int64_t total = m * roww;
  if (total > 0) {
    stage_rows_kernel<<<rt::blocks_for(total), rt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(rows), static_cast<const bool*>(alert),
        static_cast<const int64_t*>(ordinal),
        static_cast<const int32_t*>(perm), static_cast<uint32_t>(t), total,
        roww, dt_col, static_cast<int64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
