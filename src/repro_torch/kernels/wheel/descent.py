"""The R1 internal-descent tail of the cycle's delivery: `descent_tail`.

After the cycle's two full-width `deliver_rules` steps only a few
percent of the drain window is still descending through its owner's
own segment; the engine compacts those rows to the narrow width and
finishes them here: `protocol.deliver_rules(repair=True)` in a loop
over a live mask, a row staying live while its recalculated destination
stays in its owner's segment (`descent_reference`, the plain version).

Replaces the Pallas kernel `descent_tail_kernel`
(src/repro/kernels/wheel/descent.py:85). CUDA source:
``kernels/csrc/descent.cu`` with the address algebra as __device__
functions (``addressing.cuh``). Each row's result depends only on its
own values, so one thread per row looping to its own end is
bit-identical to the global loop and needs no host sync on `any(live)`.
On the H100 it is bound by bytes.
"""
from __future__ import annotations

import torch

from repro_torch.engine import protocol as proto
from repro_torch.kernels.wheel._common import (I32, I64, P, bind, check_args,
                                               in_segment, launched, on_cuda,
                                               ptr, stream_of)


def descent_reference(origin, dest, edge, has_edge, live, entry, pos_i,
                      a_prev, a_self, self_seg, max_addr, d: int):
    """Plain version: the global live-mask loop (one host read of
    `any(live)` per step). Addresses int64 (M,), flags bool (M,),
    `max_addr` an int64 tensor of one element. Returns (acc, drop,
    o_dest, o_edge, o_he)."""
    acc = torch.zeros_like(live)
    drop = torch.zeros_like(live)
    o_dest, o_edge, o_he = dest, edge, has_edge
    lv, ent, cur_d, cur_e, cur_h = live, entry, dest, edge, has_edge
    while bool(lv.any()):
        dlv = proto.deliver_rules(
            origin=origin, dest=cur_d, edge=cur_e, has_edge=cur_h,
            network_entry=ent, pos_i=pos_i, a_prev=a_prev, a_self=a_self,
            self_seg=self_seg, max_addr=max_addr, d=d, repair=True)
        moving = lv & ~dlv.accept & ~dlv.drop
        stay = moving & in_segment(dlv.new_dest, a_prev, a_self)
        fwd = moving & ~stay
        acc = acc | (lv & dlv.accept)
        drop = drop | (lv & dlv.drop & ~dlv.accept)
        ent = ent & ~stay
        cur_d = torch.where(stay, dlv.new_dest, cur_d)
        cur_e = torch.where(stay, dlv.new_edge, cur_e)
        cur_h = torch.where(stay, dlv.new_has_edge, cur_h)
        o_dest = torch.where(fwd, dlv.new_dest, o_dest)
        o_edge = torch.where(fwd, dlv.new_edge, o_edge)
        o_he = torch.where(fwd, dlv.new_has_edge, o_he)
        lv = stay
    return acc, drop, o_dest, o_edge, o_he


_ARGS = [P] * 11 + [I32, I64] + [P] * 6


def descent_tail(origin, dest, edge, has_edge, live, entry, pos_i, a_prev,
                 a_self, self_seg, max_addr, d: int):
    """The plain version on the CPU; the CUDA per-row loop for CUDA
    tensors (addresses int64 (M,), flags bool (M,), max_addr int64 (1,))."""
    if not on_cuda(origin):
        return descent_reference(origin, dest, edge, has_edge, live, entry,
                                 pos_i, a_prev, a_self, self_seg, max_addr, d)
    i64, b = torch.int64, torch.bool
    args = dict(origin=origin, dest=dest, edge=edge, has_edge=has_edge,
                live=live, entry=entry, pos_i=pos_i, a_prev=a_prev,
                a_self=a_self, self_seg=self_seg, max_addr=max_addr)
    dev = check_args("descent_tail", args, dict(
        origin=i64, dest=i64, edge=i64, has_edge=b, live=b, entry=b,
        pos_i=i64, a_prev=i64, a_self=i64, self_seg=b, max_addr=i64))
    m = origin.shape[0]
    if any(a.shape != (m,) for k, a in args.items() if k != "max_addr"):
        raise ValueError("descent_tail: every row input must be (M,)")
    if max_addr.numel() != 1 or not 1 <= d <= 32:
        raise ValueError("descent_tail: max_addr must hold one value, d <= 32")
    acc = torch.empty(m, dtype=b, device=dev)
    drop = torch.empty(m, dtype=b, device=dev)
    o_dest = torch.empty(m, dtype=i64, device=dev)
    o_edge = torch.empty(m, dtype=i64, device=dev)
    o_he = torch.empty(m, dtype=b, device=dev)
    fn = bind("descent", "rt_descent_tail", _ARGS)
    launched("descent_tail", fn(
        *(ptr(a) for a in args.values()), int(d), m, ptr(acc), ptr(drop),
        ptr(o_dest), ptr(o_edge), ptr(o_he), stream_of(dev)))
    return acc, drop, o_dest, o_edge, o_he
