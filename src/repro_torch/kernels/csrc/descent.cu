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
// test `any(live)`. Bound on the H100: bytes (52 in, 19 out per row); the
// loop is a few dozen 32-bit integer operations per step and at most a
// few dozen steps (tree depth <= d). The step cap only guards the card
// against a malformed ring, on which the reference loop would not end.
#include "addressing.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxSteps = 1 << 16;

__global__ void descent_tail_kernel(
    const int64_t* __restrict__ origin, const int64_t* __restrict__ dest,
    const int64_t* __restrict__ edge, const bool* __restrict__ has_edge,
    const bool* __restrict__ live, const bool* __restrict__ entry,
    const int64_t* __restrict__ pos_i, const int64_t* __restrict__ a_prev,
    const int64_t* __restrict__ a_self, const bool* __restrict__ self_seg,
    const int64_t* __restrict__ max_addr_p, int d, int64_t m,
    bool* __restrict__ acc_o, bool* __restrict__ drop_o,
    int64_t* __restrict__ od_o, int64_t* __restrict__ oe_o,
    bool* __restrict__ ohe_o) {
  const int64_t i = rt::global_index();
  if (i >= m) return;
  const uint32_t org = static_cast<uint32_t>(origin[i]);
  const uint32_t pos = static_cast<uint32_t>(pos_i[i]);
  const uint32_t ap = static_cast<uint32_t>(a_prev[i]);
  const uint32_t as = static_cast<uint32_t>(a_self[i]);
  const uint32_t max_addr = static_cast<uint32_t>(*max_addr_p);
  const bool sseg = self_seg[i];
  uint32_t cd = static_cast<uint32_t>(dest[i]);
  uint32_t ce = static_cast<uint32_t>(edge[i]);
  bool ch = has_edge[i];
  bool lv = live[i], ent = entry[i];
  bool acc = false, drop = false;
  uint32_t od = cd, oe = ce;
  bool oh = ch;
  for (int step = 0; lv && step < kMaxSteps; ++step) {
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
    const uint32_t nd =
        going_up ? rt::up(cd, d) : (step_cw ? rt::cw(cd, d) : rt::ccw(cd, d));
    const uint32_t ne = going_up ? 0u : (step_cw ? as : ap);
    const bool nh = !going_up;
    // R1: keep descending while the new destination is still ours
    acc = acc || accept;
    drop = drop || (dropped && !accept);
    const bool moving = !accept && !dropped;
    const bool stay = moving && rt::in_segment(nd, ap, as);
    if (stay) {
      cd = nd;
      ce = ne;
      ch = nh;
      ent = false;
    } else if (moving) {
      od = nd;
      oe = ne;
      oh = nh;
    }
    lv = stay;
  }
  acc_o[i] = acc;
  drop_o[i] = drop;
  od_o[i] = static_cast<int64_t>(od);
  oe_o[i] = static_cast<int64_t>(oe);
  ohe_o[i] = oh;
}

}  // namespace

RT_EXPORT int rt_descent_tail(const void* origin, const void* dest,
                              const void* edge, const void* has_edge,
                              const void* live, const void* entry,
                              const void* pos_i, const void* a_prev,
                              const void* a_self, const void* self_seg,
                              const void* max_addr, int32_t d, int64_t m,
                              void* acc, void* drop, void* o_dest,
                              void* o_edge, void* o_he, void* stream) {
  if (m > 0) {
    descent_tail_kernel<<<rt::blocks_for(m), rt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(origin), static_cast<const int64_t*>(dest),
        static_cast<const int64_t*>(edge), static_cast<const bool*>(has_edge),
        static_cast<const bool*>(live), static_cast<const bool*>(entry),
        static_cast<const int64_t*>(pos_i), static_cast<const int64_t*>(a_prev),
        static_cast<const int64_t*>(a_self),
        static_cast<const bool*>(self_seg),
        static_cast<const int64_t*>(max_addr), d, m,
        static_cast<bool*>(acc), static_cast<bool*>(drop),
        static_cast<int64_t*>(o_dest), static_cast<int64_t*>(o_edge),
        static_cast<bool*>(o_he));
  }
  return static_cast<int>(cudaGetLastError());
}
