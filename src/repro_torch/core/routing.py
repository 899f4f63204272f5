"""Alg. 1 — Local Binary Tree Routing (paper §2), host numpy.

Copied from `repro.core.routing` onto the port's protocol rules
(`repro_torch.engine.protocol`, whose functions take numpy arrays as
well as the engine's tensors). Two implementations share the rules:
  * `route` — single-message reference (plain Python), returns the full hop
    trace; used by tests, the stretch benchmark and the notify protocol.
  * `send_batch` / `step_batch` — vectorized (numpy) message-table versions
    used by the numpy cycle engine for the majority-voting experiments.

Protocol recap. A message carries ``(origin, dest, edge, M)`` where
``origin`` is the sender's tree position (never rewritten), ``dest`` the
current destination *address* and ``edge`` a segment edge used to kill
doomed ping-pong traffic. On delivery to the owner of ``dest`` (peer p_i,
segment (a_{i-1}, a_i], position pos_i):

  accept           iff dest == pos_i                  (and origin != pos_i)
  UP traffic       (dest fore-parent of origin)   -> newdest = UP[dest]
  CW traffic       (dest in CW subtree of origin) ->
      drop if edge == a_{i-1}
      newdest = CW[dest]  if origin == pos_i  (bounced off the sender itself)
      newdest = CCW[dest] otherwise           (step away from pos_i)
  CCW traffic      mirror image (drop if edge == a_i; self -> CCW, else CW)
  drop when a descent reaches a leaf address ("address space exhausted").

Repairs (``repair=True``, the default; ``repair=False`` is verbatim Alg. 1).
Both exist because the verbatim
pseudocode drops ~3% of CW/CCW deliveries whose Lemma-2 neighbor exists:

  R1 *internal descent.* When the recalculated destination still falls in
     the receiving peer's own segment, the peer keeps descending locally
     instead of handing the message back to the DHT (no implementation
     would route to itself). Consequently the edge-based drop check is
     applied only to messages actually received from the network. This is
     exactly the paper's stated intent for the edge check — killing
     *sender/receiver* ping-pong "because there is no peer between them" —
     without also killing a peer's own multi-step descent through its own
     segment. Hop counts below therefore count true DHT routings, matching
     the paper's stretch definition ("lets the DHT route the message").
  R2 *root wrap.* The root's segment wraps through the top of the address
     space. When a descent lands in the wrapped upper region (dest >
     max peer address), every occupied position is counterclockwise of
     dest, so the root descends CCW regardless of the self/foreign rule.
     Verbatim Alg. 1 walks clockwise into the empty region and drops
     (probability ~2^-(N-1) per edge; certainty for N=2 rings).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.engine import protocol as P

from . import addressing as A
from .addressing import UP, CW, CCW
from .dht import Ring

# router status codes
ACCEPT, FORWARD, DROP = 0, 1, 2


@dataclass
class Hop:
    dest: int  # address the DHT routed to
    peer: int  # owner peer that received it


def initial_send(
    ring: Ring, i: int, direction: int, pos: Optional[np.ndarray] = None
) -> Optional[Tuple[int, int, Optional[int]]]:
    """Downcall SEND: returns (origin_pos, dest, edge) or None if the
    direction does not exist for this peer (root UP/CCW, leaf CW/CCW)."""
    if pos is None:
        pos = ring.positions()
    p = int(pos[i])
    if direction == UP:
        if p == 0:
            return None
        return p, int(A.up(np.asarray(p, ring.addrs.dtype), ring.d)), None
    if bool(A.is_leaf(np.asarray(p, ring.addrs.dtype))) or (p == 0 and direction == CCW):
        return None
    if direction == CW:
        return p, int(A.cw(np.asarray(p, ring.addrs.dtype), ring.d)), int(ring.addrs[i])
    return p, int(A.ccw(np.asarray(p, ring.addrs.dtype), ring.d)), int(ring.prev[i])


def process_at_peer(
    ring: Ring,
    peer: int,
    origin: int,
    dest: int,
    edge: Optional[int],
    repair: bool = True,
    pos: Optional[np.ndarray] = None,
) -> Tuple[int, int, Optional[int]]:
    """Alg. 1 upcall DELIVER at `peer`, with R1 internal descent.

    Returns (status, newdest, newedge); status FORWARD means `newdest` is
    owned by a different peer and must be routed through the DHT.
    """
    d = ring.d
    dt = ring.addrs.dtype
    if pos is None:
        pos = ring.positions()
    pos_i = np.asarray(pos[peer], dt)
    a_prev = np.asarray(ring.prev[peer], dt)
    a_self = np.asarray(ring.addrs[peer], dt)
    max_addr = np.asarray(ring.addrs[-1], dt)
    network_entry = True
    # "Self" in Alg. 1's bounce rule means the message bounced off the peer
    # whose segment contains the origin position. For ordinary traffic this
    # is exactly `origin == pos_i`; testing segment ownership additionally
    # covers Alg. 2 ALERTs emulated from positions the sender does not
    # occupy (see notify.py).
    self_seg = np.asarray(int(ring.owner(np.asarray([origin], dt))[0]) == peer)

    while True:
        dlv = P.deliver_rules(
            origin=np.asarray(origin, dt),
            dest=np.asarray(dest, dt),
            edge=np.asarray(0 if edge is None else edge, dt),
            has_edge=np.asarray(edge is not None),
            network_entry=np.asarray(network_entry),
            pos_i=pos_i, a_prev=a_prev, a_self=a_self, self_seg=self_seg,
            max_addr=max_addr, d=d, repair=repair,
        )
        if bool(dlv.accept):
            return ACCEPT, dest, None
        if bool(dlv.drop):
            return DROP, 0, None
        nd = int(dlv.new_dest)
        ne = int(dlv.new_edge) if bool(dlv.new_has_edge) else None
        if not repair:
            return FORWARD, nd, ne
        # R1: keep descending locally while we still own the new destination.
        if int(ring.owner(np.asarray([nd], dt))[0]) != peer:
            return FORWARD, nd, ne
        dest, edge = nd, ne
        network_entry = False


def route(
    ring: Ring,
    i: int,
    direction: int,
    repair: bool = True,
    max_hops: int = 10_000,
    pos: Optional[np.ndarray] = None,
) -> Tuple[Optional[int], List[Hop]]:
    """Route one message from peer i in `direction` until ACCEPT or DROP.

    Returns (accepting peer index or None, hop trace). Each Hop is one DHT
    routing — the unit of the paper's stretch metric.
    """
    s = initial_send(ring, i, direction, pos=pos)
    if s is None:
        return None, []
    origin, dest, edge = s
    trace: List[Hop] = []
    for _ in range(max_hops):
        peer = int(ring.owner(np.asarray([dest], ring.addrs.dtype))[0])
        trace.append(Hop(dest, peer))
        status, newdest, newedge = process_at_peer(
            ring, peer, origin, dest, edge, repair=repair, pos=pos
        )
        if status == ACCEPT:
            return peer, trace
        if status == DROP:
            return None, trace
        dest, edge = newdest, newedge
    raise RuntimeError("routing did not terminate")


# ----------------------------------------------------------------------------
# Vectorized message-table router (simulator hot path)
# ----------------------------------------------------------------------------

def send_batch(
    ring: Ring,
    peers: np.ndarray,
    directions: np.ndarray,
    pos: Optional[np.ndarray] = None,
):
    """Vectorized initial SEND for (peer, direction) pairs.

    Returns (valid, origin, dest, edge, has_edge). Invalid sends are the
    structurally-missing directions (root UP/CCW, leaf CW/CCW); the caller
    discards them — the paper's "we prefer wasting those messages" stance.
    """
    d = ring.d
    if pos is None:
        pos = ring.positions()
    return P.send_fields(
        pos[peers], directions, ring.addrs[peers], ring.prev[peers], d
    )


def step_batch(
    ring: Ring,
    origin: np.ndarray,
    dest: np.ndarray,
    edge: np.ndarray,
    has_edge: np.ndarray,
    repair: bool = True,
    pos: Optional[np.ndarray] = None,
):
    """Vectorized Alg. 1 delivery for a batch of messages (R1/R2 included).

    One call consumes one *network* delivery per message (internal descent
    loops run to completion inside). Returns
    (status, owner_peer, newdest, newedge, new_has_edge).
    """
    d = ring.d
    dt = ring.addrs.dtype
    if pos is None:
        pos = ring.positions()
    n = origin.shape[0]
    owner0 = ring.owner(dest)
    max_addr = ring.addrs[-1]

    status = np.full(n, FORWARD, dtype=np.int64)
    out_dest = dest.copy()
    out_edge = edge.copy()
    out_has_edge = has_edge.copy()
    cur_dest = dest.copy()
    cur_edge = edge.copy()
    cur_has_edge = has_edge.copy()
    network_entry = np.ones(n, dtype=bool)
    live = np.ones(n, dtype=bool)

    for _ in range(d + 2):  # descents halve the span every step
        if not live.any():
            break
        li = np.nonzero(live)[0]
        pe = owner0[li]
        dlv = P.deliver_rules(
            origin=origin[li], dest=cur_dest[li], edge=cur_edge[li],
            has_edge=cur_has_edge[li], network_entry=network_entry[li],
            pos_i=pos[pe], a_prev=ring.prev[pe], a_self=ring.addrs[pe],
            # see process_at_peer: segment ownership covers emulated alerts
            self_seg=ring.owner(origin[li]) == pe,
            max_addr=max_addr, d=d, repair=repair,
        )
        now_acc = dlv.accept
        now_drop = dlv.drop & ~dlv.accept
        # internal descent (R1): still our own address space?
        stay = repair & (ring.owner(dlv.new_dest) == pe) & ~now_acc & ~now_drop

        status[li[now_acc]] = ACCEPT
        status[li[now_drop]] = DROP
        fwd = ~now_acc & ~now_drop & ~stay
        out_dest[li[fwd]] = dlv.new_dest[fwd]
        out_edge[li[fwd]] = dlv.new_edge[fwd]
        out_has_edge[li[fwd]] = dlv.new_has_edge[fwd]
        status[li[fwd]] = FORWARD

        live[li[~stay]] = False
        cur_dest[li[stay]] = dlv.new_dest[stay]
        cur_edge[li[stay]] = dlv.new_edge[stay]
        cur_has_edge[li[stay]] = dlv.new_has_edge[stay]
        network_entry[li[stay]] = False
        if not repair:
            live[:] = False
    return status, owner0, out_dest, out_edge, out_has_edge
