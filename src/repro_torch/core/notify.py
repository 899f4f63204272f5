"""Alg. 2 — Neighbor change notification (paper §2.2), host numpy.

Copied from `repro.core.notify` onto the port's protocol rules.

When peer p_{i-1} joins or leaves, the DHT notifies its successor p_i that
its predecessor edge changed from a_{i-2} to a_{i-1} (or vice-versa). p_i
then computes the two positions whose occupancy may have changed:

    pos_fix = Pos(a_{i-2}, a_i)          (the merged segment's position)
    pos_var = Pos(a_{i-1}, a_i)   if Pos(a_{i-2}, a_{i-1}) == pos_fix
              Pos(a_{i-2}, a_{i-1}) otherwise

and routes <ALERT, pos> in directions UP, CW and CCW *from* each of the two
positions (<= 6 tree messages). A receiver p_j classifies the alert position
against its own: fore-parent -> its UP neighbor may have changed; in its CW
subtree -> CW; else CCW (Lemma 5: at most five peers are affected).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.engine import protocol as P

from . import addressing as A
from .addressing import UP, CW, CCW
from .dht import Ring
from . import routing as R


@dataclass(frozen=True)
class Alert:
    """One tree-routed ALERT message originating at `from_pos`."""

    from_pos: int
    direction: int


@dataclass(frozen=True)
class ChurnEvent:
    """Everything one join/leave produced at the notification layer.

    `notifs` are the application-level upcalls [(peer_index, direction)]
    on the post-change ring; `deliveries` the network messages the alert
    routing consumed (the paper's message unit); `traces` one hop list
    per planned alert (None where the direction is structurally absent)
    — consumed by the cross-backend parity harness. `pos_fix`/`pos_var`
    are Alg. 2's two change positions; engines use them as the stale-
    message fence (repair R3).
    """

    notifs: List[Tuple[int, int]]
    deliveries: int
    traces: List[Optional[List[R.Hop]]]
    alerts: List[Alert]
    pos_fix: int
    pos_var: int


def change_positions(a_im2: int, a_im1: int, a_i: int, d: int, dtype=np.uint64) -> Tuple[int, int]:
    """(pos_fix, pos_var) per Alg. 2 — the shared pure rule
    (`engine.protocol.change_positions`) on host scalars."""
    dt = np.dtype(dtype).type
    pos_fix, pos_var = P.change_positions(dt(a_im2), dt(a_im1), dt(a_i), d)
    return int(pos_fix), int(pos_var)


def alerts_for_change(a_im2: int, a_im1: int, a_i: int, d: int, dtype=np.uint64) -> List[Alert]:
    """The <= 6 ALERT sends for one predecessor change (join or leave)."""
    pos_fix, pos_var = change_positions(a_im2, a_im1, a_i, d, dtype)
    pos, dirs = P.alert_plan(np.dtype(dtype).type(pos_fix),
                             np.dtype(dtype).type(pos_var))
    return [Alert(int(p), int(v)) for p, v in zip(pos, dirs)]


def route_alert_trace(
    ring: Ring, alert: Alert, pos: Optional[np.ndarray] = None
) -> Tuple[Optional[int], Optional[List[R.Hop]]]:
    """Deliver one ALERT on the *post-change* ring, with its hop trace.

    The alert is routed from `alert.from_pos` by the peer occupying the
    segment that contains it (the notifying successor emulates sends for
    positions it does not occupy itself — it knows both segments' edges).
    Returns (accepting peer index or None, hop trace or None when the
    direction is structurally absent and nothing was sent).
    """
    d = ring.d
    dt = ring.addrs.dtype
    if pos is None:
        pos = ring.positions()
    p = int(alert.from_pos)
    owner = int(ring.owner(np.asarray([p], dt))[0])
    # emulated SEND from `p` with the owning peer's segment edges — the
    # same pure rule (engine.protocol) ordinary Alg. 3 sends go through
    valid, _, dest, edge, has_edge = P.send_fields(
        np.asarray([p], dt), np.asarray([alert.direction]),
        ring.addrs[[owner]], ring.prev[[owner]], d,
    )
    if not bool(valid[0]):
        return None, None
    cur_dest = int(dest[0])
    cur_edge = int(edge[0]) if bool(has_edge[0]) else None
    trace: List[R.Hop] = []
    for _ in range(10_000):
        peer = int(ring.owner(np.asarray([cur_dest], dt))[0])
        trace.append(R.Hop(cur_dest, peer))
        status, nd, ne = R.process_at_peer(ring, peer, p, cur_dest, cur_edge, pos=pos)
        if status == R.ACCEPT:
            return peer, trace
        if status == R.DROP:
            return None, trace
        cur_dest, cur_edge = nd, ne
    raise RuntimeError("alert routing did not terminate")


def route_alert(ring: Ring, alert: Alert, pos: Optional[np.ndarray] = None) -> Optional[int]:
    """Deliver one ALERT on the post-change ring; accepting peer or None."""
    peer, _ = route_alert_trace(ring, alert, pos=pos)
    return peer


def alert_direction(alert_pos: int, self_pos: int, d: int, dtype=np.uint64) -> int:
    """ACCEPT upcall of Alg. 2: which of my neighbors may have changed."""
    dt = np.dtype(dtype).type
    return int(A.direction_of(dt(alert_pos), dt(self_pos), d))


def join_event(ring_after: Ring, new_idx: int) -> ChurnEvent:
    """Full Alg. 2 outcome of a join (notifications, cost, hop traces).

    `ring_after` contains the new peer at `new_idx`; its successor is
    new_idx+1 (cyclically).
    """
    n = ring_after.n
    succ = (new_idx + 1) % n
    a_i = int(ring_after.addrs[succ])
    a_im1 = int(ring_after.addrs[new_idx])
    a_im2 = int(ring_after.addrs[(new_idx - 1) % n])
    return _deliver(ring_after, a_im2, a_im1, a_i)


def leave_event(ring_after: Ring, ring_before: Ring, left_idx_before: int) -> ChurnEvent:
    """Full Alg. 2 outcome of a leave (notifications, cost, hop traces).

    `left_idx_before` indexes the departed peer in `ring_before`; the
    successor observes its predecessor change from the departed address
    (a_im1 in Alg. 2's naming, now gone) to the one before it.
    """
    nb = ring_before.n
    a_im1 = int(ring_before.addrs[left_idx_before])  # departed
    a_im2 = int(ring_before.addrs[(left_idx_before - 1) % nb])
    a_i = int(ring_before.addrs[(left_idx_before + 1) % nb])
    return _deliver(ring_after, a_im2, a_im1, a_i)


def notify_join(ring_after: Ring, new_idx: int) -> List[Tuple[int, int]]:
    """All (peer, direction) notifications triggered by a join."""
    return join_event(ring_after, new_idx).notifs


def notify_leave(ring_after: Ring, ring_before: Ring, left_idx_before: int) -> List[Tuple[int, int]]:
    """All (peer, direction) notifications triggered by a leave."""
    return leave_event(ring_after, ring_before, left_idx_before).notifs


def _deliver(ring: Ring, a_im2: int, a_im1: int, a_i: int) -> ChurnEvent:
    pos = ring.positions()
    pos_fix, pos_var = change_positions(a_im2, a_im1, a_i, ring.d,
                                        ring.addrs.dtype)
    p_fix, p_var = (np.dtype(ring.addrs.dtype).type(p) for p in (pos_fix, pos_var))
    plan_pos, plan_dirs = P.alert_plan(p_fix, p_var)
    alerts = [Alert(int(p), int(v)) for p, v in zip(plan_pos, plan_dirs)]
    notifs: List[Tuple[int, int]] = []
    traces: List[Optional[List[R.Hop]]] = []
    deliveries = 0
    for alert in alerts:
        peer, trace = route_alert_trace(ring, alert, pos=pos)
        traces.append(trace)
        if trace is not None:
            deliveries += len(trace)
        if peer is not None:
            notifs.append((peer, alert_direction(alert.from_pos, int(pos[peer]),
                                                 ring.d, ring.addrs.dtype.type)))
    return ChurnEvent(notifs, deliveries, traces, alerts, pos_fix, pos_var)
