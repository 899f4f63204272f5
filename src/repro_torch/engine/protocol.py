"""Alg. 1 / Alg. 2 / Alg. 3 protocol rules and the fault plane's
suspicion rule, as pure functions on torch tensors or numpy arrays.

The counterpart of `repro.engine.protocol`: the SEND construction, the
DELIVER classification (with the R1/R2 repairs), the Alg. 2 change
positions and ALERT plan, the failure detector's `suspicion_rules` and
the threshold/violation algebra. Each function dispatches on the type of
its array arguments, as `core.addressing` does: torch tensors (the
engine's path; addresses are int64 holding d-bit values, counters and
payloads int32 wrapping as the reference's int32 does) or numpy arrays
and scalars (the host layer: `core.routing`, `core.notify`,
`core.majority`; addresses keep their unsigned dtype).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import addressing as A
from repro_torch.core.addressing import CCW, CW, UP

Tensor = Any  # torch.Tensor | np.ndarray | numpy scalar


def _is_torch(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _where(c, x, y):
    if _is_torch(c, x, y):
        return torch.where(c, x, y)
    return np.where(c, x, y)


def _as(a, like):
    """`a` in the dtype of `like` (the reference's ``astype``)."""
    if isinstance(a, torch.Tensor):
        return a.to(like.dtype)
    return np.asarray(a).astype(np.asarray(like).dtype)


def _zeros_like(a, dtype=None):
    if isinstance(a, torch.Tensor):
        return torch.zeros_like(a, dtype=dtype)
    return np.zeros_like(a, dtype=dtype)


def _sum(a, axis: int):
    """Sum keeping the operand's integer dtype (torch widens int32)."""
    if isinstance(a, torch.Tensor):
        return a.sum(axis, dtype=a.dtype)
    return a.sum(axis)


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
    dest = _as(_where(dirs == UP, A.up(pos_p, d),
                      _where(dirs == CW, A.cw(pos_p, d), A.ccw(pos_p, d))),
               a_self)
    edge = _as(_where(dirs == CW, a_self, a_prev), a_self)
    has_edge = dirs != UP
    valid = _where(dirs == UP, ~root,
                   _where(dirs == CW, ~leaf, ~leaf & ~root))
    return valid, _as(pos_p, a_self), dest, edge, has_edge


# ---------------------------------------------------------------------------
# Alg. 1 — DELIVER (one local step at the owner peer)
# ---------------------------------------------------------------------------

class Delivery(NamedTuple):
    """Classification of one local Alg. 1 step (all arrays, same batch)."""

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
    kill_edge = _where(in_cw, a_prev, a_self)
    edge_kill = (network_entry & has_edge & (edge == kill_edge)
                 & ~going_up & ~at_pos)
    leaf = A.is_leaf(dest) & ~going_up & ~at_pos
    drop = (at_pos & self_send) | edge_kill | leaf

    if repair:
        root_wrap = (pos_i == 0) & (dest > max_addr)
    else:
        root_wrap = _zeros_like(at_pos)
    step_cw = ~root_wrap & _where(self_seg, in_cw, ~in_cw)
    new_dest = _as(_where(going_up, A.up(dest, d),
                          _where(step_cw, A.cw(dest, d), A.ccw(dest, d))), dest)
    new_edge = _as(_where(going_up, _zeros_like(a_self),
                          _where(step_cw, a_self, a_prev)), dest)
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
    return pos_fix, _where(pos_mid == pos_fix, pos_new, pos_mid)


def alert_plan(pos_fix: Tensor, pos_var: Tensor) -> Tuple[Tensor, Tensor]:
    """The <= 6 ALERT (position, direction) sends of one change event:
    each change position in all three directions (structurally missing
    directions are culled by `send_fields`' valid mask). Returns
    (pos (6,), dirs (6,))."""
    six = [pos_fix, pos_fix, pos_fix, pos_var, pos_var, pos_var]
    if _is_torch(pos_fix):
        pos = torch.stack(six)
        return pos, torch.tensor([UP, CW, CCW, UP, CW, CCW], device=pos.device)
    return np.stack(six), np.asarray([UP, CW, CCW, UP, CW, CCW])


# ---------------------------------------------------------------------------
# Fault plane — timeout-based suspicion / eviction
# ---------------------------------------------------------------------------

def suspicion_rules(heard: Tensor, probed: Tensor, t, suspect_after: int,
                    evict_after: int) -> Tuple[Tensor, Tensor]:
    """Per-link failure-detector masks from `last_heard` cycle stamps.

    `heard[l]` is the cycle the peer last accepted any traffic from link
    `l`, `probed[l]` the cycle it last emitted a liveness probe on it. A
    link is suspected once silent for `suspect_after` cycles (one probe
    per `suspect_after` window), and its far peer evictable once silent
    for `evict_after` cycles (0 disables eviction). Returns (probe, evict)
    bool masks; callers AND them with the link's structural validity and
    the liveness of the suspecting peer."""
    silent = _as(t - heard, heard)
    probe = (silent >= suspect_after) & ((t - probed) >= suspect_after)
    if evict_after > 0:
        evict = silent >= evict_after
    else:
        evict = _zeros_like(silent, dtype=bool)
    return probe, evict


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
    if _is_torch(in_pay):
        xp, xk = torch, torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    else:
        xp, xk = np, np.concatenate([x, np.ones_like(x[..., :1])], axis=-1)
    k = _sum(in_pay, -2) + xk
    agg = in_pay + out_pay
    viol, output = problem.test(xp, agg, k)
    pay = k[..., None, :] - in_pay
    return viol, _as(output, in_pay), pay


def majority_rules(in_ones: Tensor, in_tot: Tensor, out_ones: Tensor,
                   out_tot: Tensor, x: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The Alg. 3 majority test on (N, 3) counter planes — the
    `threshold_rules` algebra unpacked into (ones, total) planes.
    Returns (viol (N,3) bool, output (N,), pay_ones, pay_tot (N,3))."""
    k_ones = _sum(in_ones, -1) + x
    k_tot = _sum(in_tot, -1) + 1
    a_ones = in_ones + out_ones
    a_tot = in_tot + out_tot
    ta = thr2(a_ones, a_tot)
    tka = thr2(k_ones[..., None] - a_ones, k_tot[..., None] - a_tot)
    viol = ((ta >= 0) & (tka < 0)) | ((ta < 0) & (tka > 0))
    output = _as(thr2(k_ones, k_tot) >= 0, in_ones)
    return viol, output, k_ones[..., None] - in_ones, k_tot[..., None] - in_tot
