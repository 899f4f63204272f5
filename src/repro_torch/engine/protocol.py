"""Alg. 1 / Alg. 3 protocol rules as pure functions on torch tensors.

The counterpart of `repro.engine.protocol` for this slice: the SEND
construction, the DELIVER classification (with the R1/R2 repairs) and
the threshold/violation algebra. Addresses are int64 tensors holding
d-bit values (`core.addressing`); counters and payloads are int32 and
wrap as the reference's int32 does (every reduction keeps int32).

The fault plane's `suspicion_rules` belongs to a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import addressing as A
from repro_torch.core.addressing import CCW, CW, UP

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Alg. 1 — SEND
# ---------------------------------------------------------------------------

def send_fields(pos_p: Tensor, dirs: Tensor, a_self: Tensor, a_prev: Tensor,
                d: int) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Downcall SEND for (position, direction) pairs, vectorized.

    Returns (valid, origin, dest, edge, has_edge); invalid sends are the
    structurally missing directions (root UP/CCW, leaf CW/CCW).
    """
    leaf = A.is_leaf(pos_p)
    root = pos_p == 0
    dest = torch.where(dirs == UP, A.up(pos_p, d),
                       torch.where(dirs == CW, A.cw(pos_p, d), A.ccw(pos_p, d)))
    edge = torch.where(dirs == CW, a_self, a_prev)
    has_edge = dirs != UP
    valid = torch.where(dirs == UP, ~root,
                        torch.where(dirs == CW, ~leaf, ~leaf & ~root))
    return valid, pos_p, dest, edge, has_edge


# ---------------------------------------------------------------------------
# Alg. 1 — DELIVER (one local step at the owner peer)
# ---------------------------------------------------------------------------

class Delivery(NamedTuple):
    """Classification of one local Alg. 1 step (all tensors, same batch)."""

    accept: Tensor    # bool — dest == pos_i, foreign origin
    drop: Tensor      # bool — self-send / edge kill / address space exhausted
    new_dest: Tensor  # recalculated destination (where ~accept & ~drop)
    new_edge: Tensor  # segment edge attached to the forward
    new_has_edge: Tensor  # bool — UP forwards carry no edge


def deliver_rules(*, origin: Tensor, dest: Tensor, edge: Tensor,
                  has_edge: Tensor, network_entry: Tensor, pos_i: Tensor,
                  a_prev: Tensor, a_self: Tensor, self_seg: Tensor,
                  max_addr: Tensor, d: int, repair: bool = True) -> Delivery:
    """Alg. 1 upcall DELIVER at the peer owning `dest` — one step.

    `network_entry` is False while a peer keeps descending through its
    own segment (R1); `self_seg` marks messages whose origin lies in the
    receiving peer's own segment; `max_addr` is the maximum occupied
    address (R2 root wrap descends CCW above it).
    """
    at_pos = dest == pos_i
    self_send = origin == pos_i
    accept = at_pos & ~self_send

    going_up = A.is_foreparent(dest, origin, d)
    in_cw = A.in_cw_subtree(origin, dest, d)
    kill_edge = torch.where(in_cw, a_prev, a_self)
    edge_kill = (network_entry & has_edge & (edge == kill_edge)
                 & ~going_up & ~at_pos)
    leaf = A.is_leaf(dest) & ~going_up & ~at_pos
    drop = (at_pos & self_send) | edge_kill | leaf

    if repair:
        root_wrap = (pos_i == 0) & (dest > max_addr)
    else:
        root_wrap = torch.zeros_like(at_pos)
    step_cw = ~root_wrap & torch.where(self_seg, in_cw, ~in_cw)
    new_dest = torch.where(going_up, A.up(dest, d),
                           torch.where(step_cw, A.cw(dest, d), A.ccw(dest, d)))
    new_edge = torch.where(going_up, torch.zeros_like(a_self),
                           torch.where(step_cw, a_self, a_prev))
    return Delivery(accept, drop, new_dest, new_edge, ~going_up)


# ---------------------------------------------------------------------------
# Alg. 2 — tree change notification (ALERT construction)
# ---------------------------------------------------------------------------

def change_positions(a_im2: Tensor, a_im1: Tensor, a_i: Tensor,
                     d: int) -> Tuple[Tensor, Tensor]:
    """(pos_fix, pos_var) of one predecessor change, Alg. 2 verbatim.

    The successor p_i observes its predecessor edge change between
    `a_im2` and `a_im1` (join: a_im1 appeared; leave: a_im1 departed):

        pos_fix = Pos(a_im2, a_i)                   (the merged segment)
        pos_var = Pos(a_im1, a_i)   if Pos(a_im2, a_im1) == pos_fix
                  Pos(a_im2, a_im1) otherwise
    """
    pos_fix = A.position_from_segment(a_im2, a_i, d)
    pos_mid = A.position_from_segment(a_im2, a_im1, d)
    pos_new = A.position_from_segment(a_im1, a_i, d)
    return pos_fix, torch.where(pos_mid == pos_fix, pos_new, pos_mid)


def alert_plan(pos_fix: Tensor, pos_var: Tensor) -> Tuple[Tensor, Tensor]:
    """The <= 6 ALERT (position, direction) sends of one change event:
    each change position in all three directions (structurally missing
    directions are culled by `send_fields`' valid mask). Returns
    (pos (6,), dirs (6,))."""
    pos = torch.stack([pos_fix, pos_fix, pos_fix, pos_var, pos_var, pos_var])
    dirs = torch.tensor([UP, CW, CCW, UP, CW, CCW], device=pos.device)
    return pos, dirs


# ---------------------------------------------------------------------------
# Alg. 3 — threshold algebra (knowledge / agreement / violation / Send)
# ---------------------------------------------------------------------------

def thr2(ones: Tensor, total: Tensor) -> Tensor:
    """2 * thr(X): integer-exact sign of ones - total/2."""
    return 2 * ones - total


def threshold_rules(problem, in_pay: Tensor, out_pay: Tensor,
                    x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The per-peer safe-zone test for a `ThresholdProblem`, vectorized.

    ``in_pay`` / ``out_pay`` are the (..., 3, P) int32 received/sent
    payload planes and ``x`` the (..., D) own data. Returns (viol (..., 3)
    bool, output (...,) int32, pay (..., 3, P) int32) where
    pay = K - X_in is the Send(v) payload restoring agreement.
    """
    one = torch.ones_like(x[..., :1])
    k = in_pay.sum(-2, dtype=in_pay.dtype) + torch.cat([x, one], dim=-1)
    agg = in_pay + out_pay
    viol, output = problem.test(torch, agg, k)
    pay = k[..., None, :] - in_pay
    return viol, output.to(in_pay.dtype), pay


def majority_rules(in_ones: Tensor, in_tot: Tensor, out_ones: Tensor,
                   out_tot: Tensor, x: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The Alg. 3 majority test on (N, 3) counter planes — the
    `threshold_rules` algebra unpacked into (ones, total) planes.
    Returns (viol (N,3) bool, output (N,), pay_ones, pay_tot (N,3))."""
    k_ones = in_ones.sum(-1, dtype=in_ones.dtype) + x
    k_tot = in_tot.sum(-1, dtype=in_tot.dtype) + 1
    a_ones = in_ones + out_ones
    a_tot = in_tot + out_tot
    ta = thr2(a_ones, a_tot)
    tka = thr2(k_ones[..., None] - a_ones, k_tot[..., None] - a_tot)
    viol = ((ta >= 0) & (tka < 0)) | ((ta < 0) & (tka > 0))
    output = (thr2(k_ones, k_tot) >= 0).to(in_ones.dtype)
    return viol, output, k_ones[..., None] - in_ones, k_tot[..., None] - in_tot
