// due_dedup: the accept election of the drain window.
//
// Replaces the Pallas kernel due_dedup_kernel
// (src/repro/kernels/wheel/due_dedup.py:78). Semantics: the plain version
// due_dedup_reference in repro_torch/kernels/wheel/due_dedup.py, the
// dense per-link max-plane formulation of the reference engine.
//
// For each (peer, dir) link l = flat[i]: best[l] = max window index of an
// accepting DATA row on l, abest[l] = the same over ALERT rows. Per row:
// winner = acc_d && best == i; loser = acc_d && !winner;
// fresh = winner && w_seq > (abest >= 0 ? 0 : link_seq);
// alert_write = acc_a && best < 0; is_rep = (acc_d || acc_a) && i equals
// the peer-wide max over both planes; aforce[d] = abest[peer, d] >= 0.
//
// The TPU kernel elects window-locally with an O(WW^2) all-pairs max
// (6.9e10 pair tests per cycle at n = 1e6). Here the planes are two
// scratch int32 arrays of nl = 3 * pad cells, filled with atomicMax:
// max does not depend on the order of the atomics, so the result is
// bit-identical to the reference and deterministic. Three launches on
// one stream, each O(WW): (1) reset to -1 the 3 cells of every row's
// peer — exactly the cells (2) and (3) touch, so the planes are never
// cleared in full; (2) atomicMax of the window index; (3) read back and
// finalize. Bound on the H100: bytes (18 in, 8 out per row), plus the
// scattered 4-byte plane accesses.
#include "common.cuh"

namespace {

constexpr int kDirs = 3;

__global__ void reset_kernel(const int64_t* __restrict__ flat, int64_t ww,
                             int64_t nl, int32_t* __restrict__ best,
                             int32_t* __restrict__ abest) {
  const int64_t i = rt::global_index();
  if (i >= ww) return;
  const int64_t f = flat[i];
  if (f < 0 || f >= nl) return;
  const int64_t base = (f / kDirs) * kDirs;
#pragma unroll
  for (int v = 0; v < kDirs; ++v) {
    best[base + v] = -1;
    abest[base + v] = -1;
  }
}

__global__ void scatter_kernel(const int64_t* __restrict__ flat,
                               const bool* __restrict__ acc_d,
                               const bool* __restrict__ acc_a, int64_t ww,
                               int64_t nl, int32_t* __restrict__ best,
                               int32_t* __restrict__ abest) {
  const int64_t i = rt::global_index();
  if (i >= ww) return;
  const int64_t f = flat[i];
  if (f < 0 || f >= nl) return;
  if (acc_d[i]) atomicMax(best + f, static_cast<int32_t>(i));
  if (acc_a[i]) atomicMax(abest + f, static_cast<int32_t>(i));
}

__global__ void finalize_kernel(const int64_t* __restrict__ flat,
                                const bool* __restrict__ acc_d,
                                const bool* __restrict__ acc_a,
                                const int32_t* __restrict__ w_seq,
                                const int32_t* __restrict__ link_seq,
                                int64_t ww, int64_t nl,
                                const int32_t* __restrict__ best,
                                const int32_t* __restrict__ abest,
                                bool* __restrict__ winner,
                                bool* __restrict__ loser,
                                bool* __restrict__ fresh,
                                bool* __restrict__ alert_write,
                                bool* __restrict__ is_rep,
                                bool* __restrict__ aforce) {
  const int64_t i = rt::global_index();
  if (i >= ww) return;
  const int64_t f = flat[i];
  const bool di = acc_d[i], ai = acc_a[i];
  if (f < 0 || f >= nl) {  // outside the plane: the engine never sends one
    winner[i] = loser[i] = fresh[i] = alert_write[i] = is_rep[i] = false;
    for (int v = 0; v < kDirs; ++v) aforce[kDirs * i + v] = false;
    return;
  }
  const int32_t me = static_cast<int32_t>(i);
  const int32_t b = best[f], ab = abest[f];
  const bool win = di && b == me;
  winner[i] = win;
  loser[i] = di && !win;
  const int32_t floor_seq = ab >= 0 ? 0 : link_seq[i];
  fresh[i] = win && w_seq[i] > floor_seq;
  alert_write[i] = ai && b < 0;
  const int64_t base = (f / kDirs) * kDirs;
  int32_t rep = -1;
#pragma unroll
  for (int v = 0; v < kDirs; ++v) {
    const int32_t bv = best[base + v], av = abest[base + v];
    rep = max(rep, max(bv, av));
    aforce[kDirs * i + v] = av >= 0;
  }
  is_rep[i] = (di || ai) && rep == me;
}

}  // namespace

RT_EXPORT int rt_due_dedup(const void* flat, const void* acc_d,
                           const void* acc_a, const void* w_seq,
                           const void* link_seq, int64_t ww, int64_t nl,
                           void* best, void* abest, void* winner, void* loser,
                           void* fresh, void* alert_write, void* is_rep,
                           void* aforce, void* stream) {
  if (ww > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned nb = rt::blocks_for(ww);
    const int64_t* fl = static_cast<const int64_t*>(flat);
    int32_t* b = static_cast<int32_t*>(best);
    int32_t* ab = static_cast<int32_t*>(abest);
    reset_kernel<<<nb, rt::kThreads, 0, s>>>(fl, ww, nl, b, ab);
    scatter_kernel<<<nb, rt::kThreads, 0, s>>>(
        fl, static_cast<const bool*>(acc_d), static_cast<const bool*>(acc_a),
        ww, nl, b, ab);
    finalize_kernel<<<nb, rt::kThreads, 0, s>>>(
        fl, static_cast<const bool*>(acc_d), static_cast<const bool*>(acc_a),
        static_cast<const int32_t*>(w_seq),
        static_cast<const int32_t*>(link_seq), ww, nl, b, ab,
        static_cast<bool*>(winner), static_cast<bool*>(loser),
        static_cast<bool*>(fresh), static_cast<bool*>(alert_write),
        static_cast<bool*>(is_rep), static_cast<bool*>(aforce));
  }
  return static_cast<int>(cudaGetLastError());
}
