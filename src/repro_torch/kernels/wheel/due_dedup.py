"""Accept election of the drain window: `due_dedup`.

The engine's ACCEPT phase elects one data winner per (peer, direction)
link per cycle, a representative window row per touched peer for the
react, and the per-direction alert force mask. For each link,
``best`` is the max window index of the accepting DATA rows on it and
``abest`` the same over ALERT rows; the plain version computes both as
dense per-link planes of `nl` cells (the reference engine's
formulation) and derives winner, loser, fresh, alert_write, is_rep and
aforce from them.

Replaces the Pallas kernel `due_dedup_kernel`
(src/repro/kernels/wheel/due_dedup.py:78), which elects window-locally
with an O(WW^2) all-pairs max. CUDA source: ``kernels/csrc/due_dedup.cu``
takes the maxima with atomicMax instead — max does not depend on order,
so the bits are the reference's and deterministic — in O(WW) work. On
the H100 it is bound by the scattered scratch it touches, so each peer's
3 directions x {best, abest} are one 32-byte record (one sector per row
instead of a cell in each of two planes), and every cell is stamped with
the call's epoch (``(epoch << vb) | (i + 1)``, vb the bit width of WW):
a cell of an earlier call reads as none, so no pass clears the scratch
and a call is two dependent launches (atomics, then read back and
finalize).

The scratch is kept by this module per (device, nl), so a cycle
allocates none: `_PLANES` maps the key to ``[records, epoch, vb]`` —
``records`` (nl / 3, 8) int32 (bit patterns of uint32 cells; 32 bytes a
peer), the last call's epoch and vb. When the epoch would overflow its
32 - vb bits, or vb changes, the call zeroes the records first (one
memset) and restarts at epoch 1.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels.wheel._common import (I32, I64, P, U32, bind,
                                               check_args, launched, on_cuda,
                                               ptr, stream_of)

NDIR = 3

_REC = 8  # uint32 cells per peer record
_PLANES: Dict[Tuple[torch.device, int], List] = {}


def due_dedup_reference(flat, acc_d, acc_a, w_seq, link_seq, nl: int,
                        acc_p=None):
    """Plain version: the dense scatter-max plane formulation. `flat`
    (WW,) int64 link ids in [0, nl); acc_d/acc_a (WW,) bool; w_seq and
    link_seq (WW,) int32. Returns (winner, loser, fresh, alert_write,
    is_rep (WW,) bool, aforce (WW, 3) bool).

    With `acc_p` (the accepting fault-plane probes, which the kernel does
    not take: an armed engine runs this version) a third plane ``pbest``
    joins the representative election, and a seventh output, pforce
    (WW, 3) bool, marks the links whose probe forces the ack Send."""
    ww = flat.shape[0]
    wi = torch.arange(ww, dtype=torch.int32, device=flat.device)

    def plane(mask):
        p = torch.full((nl + 1,), -1, dtype=torch.int32, device=flat.device)
        p.scatter_reduce_(0, torch.where(mask, flat, nl),
                          torch.where(mask, wi, -1), reduce="amax")
        return p[:nl]

    best = plane(acc_d)
    abest = plane(acc_a)
    best_w = best[flat]
    abest_w = abest[flat]
    winner = acc_d & (wi == best_w)
    loser = acc_d & ~winner
    floor = torch.where(abest_w >= 0, 0, link_seq)
    fresh = winner & (w_seq > floor)
    alert_write = acc_a & (best_w < 0)
    recv = flat // NDIR
    cand = torch.maximum(best, abest)
    acc = acc_d | acc_a
    if acc_p is not None:
        pbest = plane(acc_p)
        cand = torch.maximum(cand, pbest)
        acc = acc | acc_p
    rep_w = cand.reshape(-1, NDIR).amax(1)[recv]
    is_rep = acc & (wi == rep_w)
    aforce = abest.reshape(-1, NDIR)[recv] >= 0
    if acc_p is None:
        return winner, loser, fresh, alert_write, is_rep, aforce
    pforce = pbest.reshape(-1, NDIR)[recv] >= 0
    return winner, loser, fresh, alert_write, is_rep, aforce, pforce


_ARGS = [P, P, P, P, P, I64, I64, P, U32, I32, I32] + [P] * 7


def due_dedup(flat, acc_d, acc_a, w_seq, link_seq, nl: int):
    """The plain version on the CPU; the CUDA election for CUDA tensors.
    The caller guarantees flat in [0, nl) (the engine's link ids are)."""
    if not on_cuda(flat):
        return due_dedup_reference(flat, acc_d, acc_a, w_seq, link_seq, nl)
    dev = check_args("due_dedup",
                     dict(flat=flat, acc_d=acc_d, acc_a=acc_a, w_seq=w_seq,
                          link_seq=link_seq),
                     dict(flat=torch.int64, acc_d=torch.bool,
                          acc_a=torch.bool, w_seq=torch.int32,
                          link_seq=torch.int32))
    ww = flat.shape[0]
    if any(a.shape != (ww,) for a in (acc_d, acc_a, w_seq, link_seq)):
        raise ValueError("due_dedup: every input must be (WW,)")
    if nl % NDIR or ww >= 2**31:
        raise ValueError("due_dedup: nl must be a multiple of 3, WW < 2^31")
    st = _PLANES.get((dev, int(nl)))
    if st is None:
        st = [torch.empty((nl // NDIR, _REC), dtype=torch.int32, device=dev),
              0, 0]
        _PLANES[(dev, int(nl))] = st
    vb = max(ww, 1).bit_length()  # window index + 1 < 2^vb
    reset = vb != st[2] or st[1] + 1 >= 1 << (32 - vb)
    epoch = 1 if reset else st[1] + 1
    outs = [torch.empty(ww, dtype=torch.bool, device=dev) for _ in range(5)]
    aforce = torch.empty((ww, NDIR), dtype=torch.bool, device=dev)
    fn = bind("due_dedup", "rt_due_dedup", _ARGS)
    launched("due_dedup", fn(
        ptr(flat), ptr(acc_d), ptr(acc_a), ptr(w_seq), ptr(link_seq), ww,
        int(nl), ptr(st[0]), epoch, vb, int(reset), *map(ptr, outs),
        ptr(aforce), stream_of(dev)))
    st[1], st[2] = epoch, vb  # only once the launch went through
    return (*outs, aforce)
