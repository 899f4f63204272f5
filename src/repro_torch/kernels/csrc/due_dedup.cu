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
// (6.9e10 pair tests per cycle at n = 1e6). Here the maxima are taken by
// atomicMax into scratch, O(WW): max does not depend on the order of the
// atomics, so the result is bit-identical to the reference and
// deterministic. What bounds it on the H100 is not the 26 streamed bytes a
// row but the scattered scratch it touches (a 32-byte sector for every
// cell, and a launch for every dependent pass), so the scratch is laid out
// for sectors and the passes for launches:
//
// - One record per peer: its 3 directions' best and abest, 6 uint32 cells
//   padded to 8, so a record is one aligned 32-byte sector. A row's
//   atomics and its read-back hit that one sector (the 6.3 M-link planes
//   at n = 1e6 become 2^21 records, 64 MB, of which a window touches at
//   most WW sectors, 8.4 MB: L2-resident).
// - No reset pass: every cell holds (epoch << vb) | (i + 1), with vb the
//   bit width of WW and the epoch one more on every call. A cell written
//   by an earlier call carries a smaller epoch, so this call's atomicMax
//   overwrites it and the read-back takes any cell of another epoch as
//   -1 (none). The wrapper counts the epochs per scratch; when they would
//   overflow 32 - vb bits, or vb changes, the call first zeroes the
//   scratch with one stream-ordered memset and starts again at epoch 1.
//
// Two dependent launches on one stream, each one thread a row: (1) the
// atomicMax of the stamped window index into the row's record; (2) read
// the record back (two 16-byte loads) and finalize.
#include "common.cuh"

namespace {

constexpr int kDirs = 3;
constexpr int kRec = 8;  // uint32 cells per peer record: best[3], abest[3]

__global__ void scatter_kernel(const int64_t* __restrict__ flat,
                               const bool* __restrict__ acc_d,
                               const bool* __restrict__ acc_a, int64_t ww,
                               int64_t nl, uint32_t stamp,
                               uint32_t* __restrict__ rec) {
  const int64_t i = rt::global_index();
  if (i >= ww) return;
  const bool d = acc_d[i], a = acc_a[i];
  if (!d && !a) return;
  const int64_t f = flat[i];
  if (f < 0 || f >= nl) return;
  uint32_t* cell = rec + (f / kDirs) * kRec + f % kDirs;
  const uint32_t val = stamp | static_cast<uint32_t>(i + 1);
  if (d) atomicMax(cell, val);
  if (a) atomicMax(cell + kDirs, val);
}

// the window index a cell holds for this call, or -1
__device__ __forceinline__ int32_t read_cell(uint32_t c, uint32_t epoch,
                                             int vb) {
  return (c >> vb) == epoch
             ? static_cast<int32_t>(c & ((1u << vb) - 1u)) - 1
             : -1;
}

__global__ void finalize_kernel(const int64_t* __restrict__ flat,
                                const bool* __restrict__ acc_d,
                                const bool* __restrict__ acc_a,
                                const int32_t* __restrict__ w_seq,
                                const int32_t* __restrict__ link_seq,
                                int64_t ww, int64_t nl, uint32_t epoch,
                                int vb, const uint32_t* __restrict__ rec,
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
  const uint4* r = reinterpret_cast<const uint4*>(rec + (f / kDirs) * kRec);
  const uint4 lo = r[0], hi = r[1];
  const int32_t b0 = read_cell(lo.x, epoch, vb), b1 = read_cell(lo.y, epoch, vb),
                b2 = read_cell(lo.z, epoch, vb), a0 = read_cell(lo.w, epoch, vb),
                a1 = read_cell(hi.x, epoch, vb), a2 = read_cell(hi.y, epoch, vb);
  const int dir = static_cast<int>(f % kDirs);
  const int32_t b = dir == 0 ? b0 : dir == 1 ? b1 : b2;
  const int32_t ab = dir == 0 ? a0 : dir == 1 ? a1 : a2;
  const int32_t me = static_cast<int32_t>(i);
  const bool win = di && b == me;
  winner[i] = win;
  loser[i] = di && !win;
  fresh[i] = win && w_seq[i] > (ab >= 0 ? 0 : link_seq[i]);
  alert_write[i] = ai && b < 0;
  const int32_t rep = max(max(max(b0, b1), max(b2, a0)), max(a1, a2));
  is_rep[i] = (di || ai) && rep == me;
  aforce[kDirs * i] = a0 >= 0;
  aforce[kDirs * i + 1] = a1 >= 0;
  aforce[kDirs * i + 2] = a2 >= 0;
}

}  // namespace

// rec: (nl / 3) * 8 uint32 cells; epoch >= 1 and < 2^(32 - vb), with
// WW < 2^vb; reset: zero the records first (a new scratch, a new vb, or
// the epochs ran out).
RT_EXPORT int rt_due_dedup(const void* flat, const void* acc_d,
                           const void* acc_a, const void* w_seq,
                           const void* link_seq, int64_t ww, int64_t nl,
                           void* rec, uint32_t epoch, int vb, int reset,
                           void* winner, void* loser, void* fresh,
                           void* alert_write, void* is_rep, void* aforce,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* r = static_cast<uint32_t*>(rec);
  if (reset) {
    const cudaError_t e = cudaMemsetAsync(
        r, 0, static_cast<size_t>(nl / kDirs) * kRec * sizeof(uint32_t), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (ww > 0) {
    const unsigned nb = rt::blocks_for(ww);
    const int64_t* fl = static_cast<const int64_t*>(flat);
    const bool* ad = static_cast<const bool*>(acc_d);
    const bool* aa = static_cast<const bool*>(acc_a);
    scatter_kernel<<<nb, rt::kThreads, 0, s>>>(fl, ad, aa, ww, nl,
                                               epoch << vb, r);
    finalize_kernel<<<nb, rt::kThreads, 0, s>>>(
        fl, ad, aa, static_cast<const int32_t*>(w_seq),
        static_cast<const int32_t*>(link_seq), ww, nl, epoch, vb, r,
        static_cast<bool*>(winner), static_cast<bool*>(loser),
        static_cast<bool*>(fresh), static_cast<bool*>(alert_write),
        static_cast<bool*>(is_rep), static_cast<bool*>(aforce));
  }
  return static_cast<int>(cudaGetLastError());
}
