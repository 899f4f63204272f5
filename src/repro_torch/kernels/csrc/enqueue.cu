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
// element computes the stamp (its trial's 10-entry perm and time are
// read through L1). Batched trials are equal trial-major blocks of
// rows_per_trial rows, each with its own perm row and time.
#include "common.cuh"

namespace {

// 32-bit indices (the wrapper refuses a block of 2^32 - 256 elements or
// more, 34 GB of rows): the row and trial divisions a thread makes are
// 32-bit ones, not the 64-bit division routine
__global__ void stage_rows_kernel(const int64_t* __restrict__ rows,
                                  const bool* __restrict__ alert,
                                  const int64_t* __restrict__ ordinal,
                                  const int32_t* __restrict__ perm,
                                  const int32_t* __restrict__ t,
                                  uint32_t rows_per_trial, uint32_t total,
                                  uint32_t roww, uint32_t dt_col,
                                  int64_t* __restrict__ out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t r = i / roww;
  if (i - r * roww != dt_col) {
    out[i] = rows[i];
    return;
  }
  // floor mod: C++ % truncates, and a leading dead row's ordinal -1
  // must read delay class 9
  const uint32_t trial = r / rows_per_trial;
  const int cls = static_cast<int>(((ordinal[r] % 10) + 10) % 10);
  const uint32_t delay =
      alert[r] ? 1u : static_cast<uint32_t>(perm[trial * 10 + cls]);
  const uint32_t tt = static_cast<uint32_t>(t[trial]);
  out[i] = static_cast<int64_t>(static_cast<uint32_t>(tt + delay));  // wraps at 32 bits
}

}  // namespace

RT_EXPORT int rt_stage_rows(const void* rows, const void* alert,
                            const void* ordinal, const void* perm,
                            const void* t, int64_t rows_per_trial, int64_t m,
                            int32_t roww, int32_t dt_col,
                            void* out, void* stream) {
  const int64_t total = m * roww;
  if (total > 0) {
    stage_rows_kernel<<<rt::blocks_for(total), rt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(rows), static_cast<const bool*>(alert),
        static_cast<const int64_t*>(ordinal),
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(t),
        static_cast<uint32_t>(rows_per_trial), static_cast<uint32_t>(total),
        static_cast<uint32_t>(roww), static_cast<uint32_t>(dt_col),
        static_cast<int64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
