// descent_tail: the R1 internal-descent tail of the cycle's delivery.
//
// Replaces the Pallas kernel descent_tail_kernel
// (src/repro/kernels/wheel/descent.py:85). Semantics: the plain version
// descent_reference in repro_torch/kernels/wheel/descent.py — a loop of
// protocol.deliver_rules(repair=True) over a live mask, a row staying
// live while its recalculated destination stays in its own segment.
//
// Each row's result depends only on its own values, so one thread per row
// looping until the row accepts, drops or leaves its segment is
// bit-identical to the global live-mask loop, and needs no host sync to
// test `any(live)`. Bound on the H100: bytes. The engine passes the tail at
// a fixed width and most rows are not live (>= 85 % at n = 1e6), and a row
// that is not live passes dest, edge and has_edge through with acc = drop
// = false: so each thread reads `live` with those three (18 bytes), and
// only a live row reads the other six inputs (34 bytes more), all as
// 32-bit low words of the int64 addresses. Outputs: 19 bytes a row, into
// two buffers (flags (3, M) bool, addresses (2, M) int64). Blocks of 128
// rows spread the tail's ~33K rows over all 132 SMs. The loop is a few
// dozen dependent 32-bit integer operations per step and at most a few
// dozen steps (tree depth <= d): the longest row's serial steps, with the
// launch and the reads, set the kernel's time, not its bytes. The step
// cap only guards the card against a malformed ring, on which the
// reference loop would not end. A batched engine's tail is B equal
// trial-major blocks of rows_per_trial rows, each trial with its own ring
// maximum (max_addr[trial]).
#include "addressing.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxSteps = 1 << 16;
constexpr int kRows = 128;  // threads (rows) per block

// the low 32-bit word of int64 element i (addresses are < 2^32)
__device__ __forceinline__ uint32_t lo(const int64_t* p, int64_t i) {
  return reinterpret_cast<const uint32_t*>(p)[2 * i];
}

__global__ void __launch_bounds__(kRows) descent_tail_kernel(
    const int64_t* __restrict__ origin, const int64_t* __restrict__ dest,
    const int64_t* __restrict__ edge, const bool* __restrict__ has_edge,
    const bool* __restrict__ live, const bool* __restrict__ entry,
    const int64_t* __restrict__ pos_i, const int64_t* __restrict__ a_prev,
    const int64_t* __restrict__ a_self, const bool* __restrict__ self_seg,
    const int64_t* __restrict__ max_addr_p, int d, int64_t m,
    int64_t rows_per_trial, bool* __restrict__ flags,
    int64_t* __restrict__ addrs) {
  const int64_t i = rt::global_index();
  if (i >= m) return;
  uint32_t cd = lo(dest, i), ce = lo(edge, i);
  bool ch = has_edge[i];
  bool acc = false, drop = false;
  uint32_t od = cd, oe = ce;
  bool oh = ch;
  if (live[i]) {
    const uint32_t org = lo(origin, i), pos = lo(pos_i, i);
    const uint32_t ap = lo(a_prev, i), as = lo(a_self, i);
    const uint32_t max_addr =
        lo(max_addr_p, i < rows_per_trial ? 0 : i / rows_per_trial);
    const bool sseg = self_seg[i];
    bool ent = entry[i];
    for (int step = 0; step < kMaxSteps; ++step) {
      // protocol.deliver_rules, one local step at the owner peer
      const bool at_pos = cd == pos;
      const bool self_send = org == pos;
      const bool accept = at_pos && !self_send;
      const bool going_up = rt::is_foreparent(cd, org, d);
      const bool in_cw = rt::in_cw_subtree(org, cd, d);
      const uint32_t kill_edge = in_cw ? ap : as;
      const bool edge_kill =
          ent && ch && ce == kill_edge && !going_up && !at_pos;
      const bool leaf = rt::is_leaf(cd) && !going_up && !at_pos;
      const bool dropped = (at_pos && self_send) || edge_kill || leaf;
      const bool root_wrap = pos == 0u && cd > max_addr;  // R2 repair
      const bool step_cw = !root_wrap && (sseg ? in_cw : !in_cw);
      const uint32_t nd = going_up ? rt::up(cd, d)
                                   : (step_cw ? rt::cw(cd, d) : rt::ccw(cd, d));
      const uint32_t ne = going_up ? 0u : (step_cw ? as : ap);
      const bool nh = !going_up;
      // R1: keep descending while the new destination is still ours
      acc = acc || accept;
      drop = drop || (dropped && !accept);
      const bool moving = !accept && !dropped;
      if (!(moving && rt::in_segment(nd, ap, as))) {
        if (moving) {
          od = nd;
          oe = ne;
          oh = nh;
        }
        break;
      }
      cd = nd;
      ce = ne;
      ch = nh;
      ent = false;
    }
  }
  flags[i] = acc;
  flags[m + i] = drop;
  flags[2 * m + i] = oh;
  addrs[i] = static_cast<int64_t>(od);
  addrs[m + i] = static_cast<int64_t>(oe);
}

}  // namespace

// flags: bool (3, M), rows acc, drop, o_has_edge; addrs: int64 (2, M),
// rows o_dest, o_edge.
RT_EXPORT int rt_descent_tail(const void* origin, const void* dest,
                              const void* edge, const void* has_edge,
                              const void* live, const void* entry,
                              const void* pos_i, const void* a_prev,
                              const void* a_self, const void* self_seg,
                              const void* max_addr, int32_t d, int64_t m,
                              int64_t rows_per_trial, void* flags,
                              void* addrs, void* stream) {
  if (m > 0) {
    descent_tail_kernel<<<rt::blocks_for(m, kRows), kRows, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(origin), static_cast<const int64_t*>(dest),
        static_cast<const int64_t*>(edge), static_cast<const bool*>(has_edge),
        static_cast<const bool*>(live), static_cast<const bool*>(entry),
        static_cast<const int64_t*>(pos_i), static_cast<const int64_t*>(a_prev),
        static_cast<const int64_t*>(a_self),
        static_cast<const bool*>(self_seg),
        static_cast<const int64_t*>(max_addr), d, m, rows_per_trial,
        static_cast<bool*>(flags), static_cast<int64_t*>(addrs));
  }
  return static_cast<int>(cudaGetLastError());
}
