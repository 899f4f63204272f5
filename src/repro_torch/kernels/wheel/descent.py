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
Its bound on the H100 is bytes: a row that is not live (most of the
fixed-width tail) reads only live, dest, edge and has_edge, and the five
outputs are rows of two buffers. In practice it waits on latency: the
launch, the reads, and its longest row's serial steps.

A batched engine passes every trial's tail in one call, trial-major in
equal blocks, with one ring maximum (`max_addr`, the R2 repair's bound)
per trial.
"""
from __future__ import annotations

import torch

from repro_torch.engine import protocol as proto
from repro_torch.kernels.wheel._common import (I32, I64, P, bind, in_segment,
                                               launched, on_cuda, ptr,
                                               stream_of)


def descent_reference(origin, dest, edge, has_edge, live, entry, pos_i,
                      a_prev, a_self, self_seg, max_addr, d: int):
    """Plain version: the global live-mask loop (one host read of
    `any(live)` per step). Addresses int64 (M,), flags bool (M,),
    `max_addr` int64 (B,): one per trial, row r being trial r // (M / B)'s
    (B = 1: one ring). Returns (acc, drop, o_dest, o_edge, o_he)."""
    b, m = max_addr.numel(), origin.shape[0]
    if b > 1:
        max_addr = max_addr[torch.arange(m, device=origin.device) // (m // b)]
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


_ARGS = [P] * 11 + [I32, I64, I64] + [P] * 3
_NAMES = ("origin", "dest", "edge", "has_edge", "live", "entry", "pos_i",
          "a_prev", "a_self", "self_seg")
_I64, _B = torch.int64, torch.bool
_DTYPES = (_I64, _I64, _I64, _B, _B, _B, _I64, _I64, _I64, _B)


def descent_tail(origin, dest, edge, has_edge, live, entry, pos_i, a_prev,
                 a_self, self_seg, max_addr, d: int):
    """The plain version on the CPU; the CUDA per-row loop for CUDA
    tensors (addresses int64 (M,), flags bool (M,), max_addr int64 (B,)
    for B equal trial-major blocks of rows). Returns (acc, drop, o_dest,
    o_edge, o_he)."""
    if not on_cuda(origin):
        return descent_reference(origin, dest, edge, has_edge, live, entry,
                                 pos_i, a_prev, a_self, self_seg, max_addr, d)
    rows = (origin, dest, edge, has_edge, live, entry, pos_i, a_prev, a_self,
            self_seg)
    dev, m = origin.device, origin.shape[0]
    for name, x, dt in zip(_NAMES, rows, _DTYPES):  # one pass over the rows
        if x.dtype != dt:
            raise TypeError(f"descent_tail: {name} has dtype {x.dtype}, want "
                            f"{dt}")
        if x.device != dev or x.shape != (m,) or not x.is_contiguous():
            raise ValueError(f"descent_tail: {name} must be a contiguous "
                             f"({m},) tensor on {dev}, got {tuple(x.shape)} "
                             f"on {x.device}")
    b = max_addr.numel()
    if (max_addr.dtype != _I64 or max_addr.device != dev or b < 1 or m % b
            or not max_addr.is_contiguous() or not 1 <= d <= 32):
        raise ValueError("descent_tail: max_addr must be contiguous int64 on "
                         "the rows' device, one per equal block of rows; "
                         "d <= 32")
    flags = torch.empty((3, m), dtype=_B, device=dev)
    addrs = torch.empty((2, m), dtype=_I64, device=dev)
    fn = bind("descent", "rt_descent_tail", _ARGS)
    launched("descent_tail", fn(
        *(ptr(x) for x in rows), ptr(max_addr), int(d), m,
        max(m // b, 1), ptr(flags),
        ptr(addrs), stream_of(dev)))
    acc, drop, o_he = flags.unbind(0)
    o_dest, o_edge = addrs.unbind(0)
    return acc, drop, o_dest, o_edge, o_he
