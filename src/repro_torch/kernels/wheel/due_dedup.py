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
fills the planes with atomicMax instead — max does not depend on order,
so the bits are the reference's and deterministic — and resets only the
cells the window touches, so the work is O(WW). On the H100 it is bound
by bytes. The two int32 planes are scratch kept by this module per
(device, nl), so a cycle allocates none.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.wheel._common import (I64, P, bind, check_args,
                                               launched, on_cuda, ptr,
                                               stream_of)

NDIR = 3

_PLANES: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def due_dedup_reference(flat, acc_d, acc_a, w_seq, link_seq, nl: int):
    """Plain version: the dense scatter-max plane formulation. `flat`
    (WW,) int64 link ids in [0, nl); acc_d/acc_a (WW,) bool; w_seq and
    link_seq (WW,) int32. Returns (winner, loser, fresh, alert_write,
    is_rep (WW,) bool, aforce (WW, 3) bool)."""
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
    rep_w = torch.maximum(best, abest).reshape(-1, NDIR).amax(1)[recv]
    is_rep = (acc_d | acc_a) & (wi == rep_w)
    aforce = abest.reshape(-1, NDIR)[recv] >= 0
    return winner, loser, fresh, alert_write, is_rep, aforce


_ARGS = [P, P, P, P, P, I64, I64] + [P] * 9


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
    key = (dev, int(nl))
    planes = _PLANES.get(key)
    if planes is None:
        planes = tuple(torch.empty(nl, dtype=torch.int32, device=dev)
                       for _ in range(2))
        _PLANES[key] = planes
    outs = [torch.empty(ww, dtype=torch.bool, device=dev) for _ in range(5)]
    aforce = torch.empty((ww, NDIR), dtype=torch.bool, device=dev)
    fn = bind("due_dedup", "rt_due_dedup", _ARGS)
    launched("due_dedup", fn(
        ptr(flat), ptr(acc_d), ptr(acc_a), ptr(w_seq), ptr(link_seq), ww,
        int(nl), ptr(planes[0]), ptr(planes[1]), *map(ptr, outs),
        ptr(aforce), stream_of(dev)))
    return (*outs, aforce)
