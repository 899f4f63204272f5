"""Alg. 3 — DHT local thresholding (paper §3.1), vectorized simulator.

Copied from `repro.core.majority` onto the port's protocol rules and
problems (`repro_torch.engine.protocol` / `.problems`, on numpy arrays):
the reference cycle simulator behind the port's numpy oracle, with the
fault plane's host eviction helpers that `TorchEngine._fault_sweep`
shares (`monitored_links`, `resolve_far`, `accuse`, `elect_eviction`,
`eviction_grace`).

The simulator runs ANY `ThresholdProblem` — the paper's majority vote is the default instance.
Per-peer state (directions v in {UP, CW, CCW}; P = D + 1 payload width):

  X_in[i, v]  = (vec, count)  latest payload *received* from direction v
  X_out[i, v] = (vec, count)  latest payload *sent* to direction v
  data[i]     = (D,)          the peer's own data vector (majority: the vote)
  seq[i], last[i, v]          sequence numbers (out-of-order drop)

Knowledge   K_i     = (data_i, 1) + sum_v X_in[v]
Agreement   A_{i,v} = X_in[v] + X_out[v]
Margin      f(X)    = problem.margin — for majority the paper's
                      (1,-1/2)^t X, i.e. 2*ones - total in integers

Violation in direction v (the safe-zone test, paper §3.1):
      f(A) >= 0  and  f(K - A) <  0
   or f(A) <  0  and  f(K - A) >  0
On violation: X_out[v] <- K - X_in[v]; send (X_out[v], ++seq) towards v —
after which A_{i,v} = K_i and the violation is resolved locally.

Output: 1 iff f(K) >= 0.

The event sources are exactly the paper's: initialization, a change of the
peer's own data, an incoming message, or an Alg. 2 ALERT (which zeroes
X_in[v] and forces a send).

The implementation is a cycle-driven simulation over a vectorized peer
state; messages travel through the Alg. 1 batch router with 1..10 cycle
delays per network hop (paper §4). Message counts are reported per network
delivery, the same unit LiMoSense is charged in.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.engine import protocol as P
from repro_torch.engine.problems import MAJORITY, ThresholdProblem, get_problem
from repro_torch.engine.protocol import thr2  # noqa: F401  (re-export, public API)

from . import addressing as A
from .addressing import UP, CW, CCW
from .dht import Ring
from . import notify as N
from . import routing as R
from .simulator import KIND_DATA, KIND_PROBE, MessageTable, random_delays

NDIR = 3


def monitored_links(ring: Ring, pos: np.ndarray, dead: np.ndarray):
    """(peers, dirs, monitored) over every (peer, dir) pair of `ring`:
    `monitored` keeps links that structurally exist and whose near end
    is alive. No first-hop self test: a link whose dest address the
    near peer owns itself can still *route* to another peer (descent
    through the peer's own unoccupied positions), so filtering on the
    first hop would blind the detector to exactly those neighbors —
    self-resolving links instead stay fresh through their own probe
    accepts and wasted directions are filtered by `resolve_far` (-1) at
    eviction time. Module-level (pure host numpy) so the device
    backends' boundary eviction sweep shares the exact link-selection
    rule with the reference detector."""
    n = int(ring.n)
    peers = np.repeat(np.arange(n, dtype=np.int64), NDIR)
    dirs = np.tile(np.arange(NDIR, dtype=np.int64), n)
    valid, _, _, _, _ = R.send_batch(ring, peers, dirs, pos=pos)
    monitored = valid & ~dead[peers]
    return peers, dirs, monitored


def resolve_far(ring: Ring, pos: np.ndarray, peers: np.ndarray,
                dirs: np.ndarray) -> np.ndarray:
    """The *effective* tree neighbor of each (peer, dir) link: the peer
    a message sent on that link would be accepted at, found by the
    ordinary Alg. 1 routing (owner-of-neighbor-position is NOT it —
    routing descends through unoccupied positions). -1 for the wasted
    directions whose sends die at an unoccupied leaf; those links stay
    silent forever but can never evict anyone."""
    valid, origin, dest, edge, has_edge = R.send_batch(
        ring, peers, dirs, pos=pos)
    far = np.full(peers.shape, -1, np.int64)
    act = valid.copy()
    dest, edge, has_edge = dest.copy(), edge.copy(), has_edge.copy()
    for _ in range(4 * ring.d + 8):
        ai = np.nonzero(act)[0]
        if ai.size == 0:
            break
        status, owner, nd, ne, nhe = R.step_batch(
            ring, origin[ai], dest[ai], edge[ai], has_edge[ai], pos=pos)
        acc = status == R.ACCEPT
        far[ai[acc]] = owner[acc]
        act[ai[acc | (status == R.DROP)]] = False
        fwd = status == R.FORWARD
        dest[ai[fwd]] = nd[fwd]
        edge[ai[fwd]] = ne[fwd]
        has_edge[ai[fwd]] = nhe[fwd]
    return far


NEVER_HEARD = -(1 << 30)  # int32-safe "no link ever resolved here"


def accuse(ring: Ring, pos: np.ndarray, peers: np.ndarray,
           dirs: np.ndarray, stamps: np.ndarray, last_heard: np.ndarray,
           fresh: np.ndarray, margin: int) -> np.ndarray:
    """Per-link accused peer index (-1: nobody) for *stale* links.

    A silent link cannot know WHERE on its route the traffic died — a
    probe swallowed by a crashed transit hop leaves the link exactly as
    silent as a dead far endpoint would, so blaming the resolved
    endpoint convicts bystanders whose only inbound routes transit a
    crashed peer. Evidence is only good up to the first silent hop:
    each stale link walks its Alg. 1 route in hop order and accuses the
    first handling owner that cannot be exonerated. A hop is
    transparent only when somebody heard it *after this link's probes
    started dying* — `last_heard[hop] > stamp + margin`, one probe
    round past the link's own stamp. The absolute `evict_after`
    horizon is not enough for transit: in a quiet converged network
    links go stale at different phases, so a transit peer crashing
    *after* the link's last refresh still looks fresh at the eviction
    horizon while it silently eats every probe. An unexonerated hop
    that is still inside the horizon therefore *blocks* the walk
    without being accused (it may be the culprit, but freshness
    vetoes conviction — it either answers a probe soon or matures
    into an accusable corpse); an unexonerated hop past the horizon
    takes the blame. The near peer's own hops are skipped, and a
    route whose every hop is vouched for accuses nobody (its silence
    is the route's fault, not the endpoint's)."""
    valid, origin, dest, edge, has_edge = R.send_batch(
        ring, peers, dirs, pos=pos)
    accused = np.full(peers.shape, -1, np.int64)
    act = valid.copy()
    dest, edge, has_edge = dest.copy(), edge.copy(), has_edge.copy()
    for _ in range(4 * ring.d + 8):
        ai = np.nonzero(act)[0]
        if ai.size == 0:
            break
        status, owner, nd, ne, nhe = R.step_batch(
            ring, origin[ai], dest[ai], edge[ai], has_edge[ai], pos=pos)
        blocked = ((owner != peers[ai])
                   & (last_heard[owner] <= stamps[ai] + margin))
        dark = blocked & ~fresh[owner]
        accused[ai[dark]] = owner[dark]
        fwd = (status == R.FORWARD) & ~blocked
        act[ai[~fwd]] = False
        dest[ai[fwd]] = nd[fwd]
        edge[ai[fwd]] = ne[fwd]
        has_edge[ai[fwd]] = nhe[fwd]
    return accused


def elect_eviction(ring: Ring, pos: np.ndarray, peers: np.ndarray,
                   dirs: np.ndarray, monitored: np.ndarray,
                   evict: np.ndarray, heard: np.ndarray,
                   margin: int) -> int:
    """First-dark-hop accused peer with the lowest address, or -1.

    `heard` is the flat per-(peer, dir) stamp table aligned with
    `peers`/`dirs` (the caller passes its effective stamps — grace
    floors and overlays already applied); `margin` is the exoneration
    window, one probe round (`eviction_grace` at the caller). Two
    gates protect live peers. Freshness vetoes absolutely: a peer some
    monitored link heard within `evict_after` cannot be accused — a
    live peer keeps at least one inbound link fresh through probe acks
    once a clear route to it exists. Then every link silent past
    `evict_after` blames the first hop on its route that nobody heard
    past the link's own stamp plus `margin` (`accuse`): a crashed
    transit peer soaks up the blame for every route it blocks, and the
    bystanders behind it stay untouched until the tree re-heals and a
    probe reaches them. Mass failures drain one eviction per call: the
    caller re-resolves routes and re-reads the stamps after each
    synthesized leave, so accusations the eviction just explained
    dissolve before they can fire."""
    m = np.nonzero(monitored)[0]
    if m.size == 0:
        return -1
    far = resolve_far(ring, pos, peers[m], dirs[m])
    # wasted directions (-1) and self-resolving links (a peer's own
    # silence never vouches for the peer itself) do not veto
    ok = (far >= 0) & (far != peers[m])
    n = int(ring.n)
    stamps = np.asarray(heard, np.int64)
    last_heard = np.full(n, NEVER_HEARD, np.int64)
    np.maximum.at(last_heard, far[ok], stamps[m][ok])
    fresh = np.zeros(n, bool)
    fresh[far[ok & ~evict[m]]] = True
    # only structurally resolving links accuse: a wasted direction
    # (far == -1, its sends R2-drop at a leaf) or a self-resolving link
    # is silent even in a fully healthy network, so its staleness
    # carries no evidence about anyone on its route
    s = m[evict[m] & ok]
    if s.size == 0:
        return -1
    accused = accuse(ring, pos, peers[s], dirs[s], stamps[s],
                     last_heard, fresh, int(margin))
    cand = np.unique(accused[accused >= 0])
    if cand.size == 0:
        return -1
    return int(cand[np.argmin(ring.addrs[cand])])


def eviction_grace(n: int, suspect_after: int) -> int:
    """Minimum conviction deferral after a synthesized leave.

    Unanimity alone cannot protect a peer route-isolated by a
    *contiguous* dead range (`range_fail`): every one of its links goes
    stale, so no veto exists, and a sweep that drains the whole range
    back-to-back would evict the bystander before a single probe could
    cross the re-healed routes. Each eviction therefore defers further
    convictions by one probe round (the `suspect_after` rate limit) plus
    a control-plane round trip at tree depth — long enough for a live
    peer's probe ack to land, short enough that a real mass failure
    still drains in O(crashes * grace) cycles."""
    depth = int(np.ceil(np.log2(max(int(n), 2))))
    return int(suspect_after) + 2 * depth + 8


class MajorityState:
    """Vectorized Alg. 3 state for all n peers, problem-generic.

    `data` is the (n, D) int64 per-peer data plane; `x` stays the
    majority-era (n,) view of its single column (readable AND
    index-assignable — it is a numpy view)."""

    def __init__(self, n: int, x: np.ndarray,
                 problem: Optional[ThresholdProblem] = None):
        self.problem = get_problem(problem)
        self.n = n
        data = np.asarray(x, np.int64)
        self.data = (data[:, None] if data.ndim == 1 else data).copy()
        assert self.data.shape == (n, self.problem.data_width)
        pw = self.problem.payload_width
        self.X_in = np.zeros((n, NDIR, pw), np.int64)
        self.X_out = np.zeros((n, NDIR, pw), np.int64)
        self.seq = np.zeros(n, np.int64)
        self.last = np.zeros((n, NDIR), np.int64)

    @property
    def x(self) -> np.ndarray:
        """(n,) scalar-data view (majority votes); (n, D) when D > 1."""
        return self.data[:, 0] if self.data.shape[1] == 1 else self.data

    def knowledge(self, idx: Optional[np.ndarray] = None) -> np.ndarray:
        """(n|len(idx), P) K_i = (data_i, 1) + sum_v X_in."""
        xin = self.X_in if idx is None else self.X_in[idx]
        data = self.data if idx is None else self.data[idx]
        k = xin.sum(axis=1)
        k[:, :-1] += data
        k[:, -1] += 1
        return k

    def _rules(self, idx: Optional[np.ndarray] = None):
        """The shared safe-zone test (engine.protocol) on (a subset of)
        peers: (viol (k,3), output (k,), pay (k,3,P))."""
        xin = self.X_in if idx is None else self.X_in[idx]
        xout = self.X_out if idx is None else self.X_out[idx]
        data = self.data if idx is None else self.data[idx]
        return P.threshold_rules(self.problem, xin, xout, data)

    def outputs(self) -> np.ndarray:
        # only the output column is needed here (hot convergence check);
        # the full rule set (violations/payloads) runs in _rules()
        k = self.knowledge()
        return (self.problem.margin(np, k) >= 0).astype(np.int64)

    def violations(self, idx: Optional[np.ndarray] = None) -> np.ndarray:
        """(n|len(idx), 3) bool — the paper's test() per peer and direction."""
        viol, _, _ = self._rules(idx)
        return viol


class MajoritySimulator:
    """Cycle-driven co-simulation of Alg. 1 + Alg. 3, with Alg. 2 churn
    (`join` / `leave` re-route in-flight traffic against the changed ring
    and fire the notification upcalls). `problem` selects the threshold
    decision rule (default: the paper's majority vote)."""

    def __init__(self, ring: Ring, votes: np.ndarray, seed: int = 0,
                 problem: Optional[ThresholdProblem] = None, faults=None):
        self.problem = get_problem(problem)
        data = self.problem.init_state(votes)
        assert data.shape[0] == ring.n
        self.ring = ring
        self.pos = ring.positions()
        self.state = MajorityState(ring.n, data, problem=self.problem)
        self.rng = np.random.default_rng(seed)
        self.msgs = MessageTable(addr_dtype=ring.addrs.dtype,
                                 payload_width=self.problem.payload_width)
        # peer index -> position lookups for accepted-message direction
        self.t = 0
        self.messages_sent = 0  # network deliveries consumed (paper's unit)
        # output-moving event since the last convergence check? (engine
        # layer caches its convergence predicate behind this flag)
        self.dirty = True
        # -- fault plane — present but inert when disarmed
        self.faults = faults  # engine.base.FaultConfig | None
        # per-(peer, dir) failure-detector stamps: last cycle any traffic
        # was accepted from / a probe was emitted towards that tree link
        self.heard = np.zeros((ring.n, NDIR), np.int64)
        self.probed = np.zeros((ring.n, NDIR), np.int64)
        self.dead = np.zeros(ring.n, bool)  # crashed, not yet evicted
        self.evictions = []  # [(cycle, evicted address), ...]
        self._evict_floor = -(1 << 30)  # conviction grace after evictions
        # fault draws come from their own stream so arming the plane with
        # p_drop = p_delay = 0 leaves the message trajectory untouched
        self.frng = (np.random.default_rng(faults.seed)
                     if faults is not None else None)
        self._trigger_all_initial()

    # -- sending ------------------------------------------------------------
    def _send(self, peers: np.ndarray, dirs: np.ndarray,
              pay: Optional[np.ndarray] = None):
        """Alg. 3 Send(v) for (peer, dir) pairs: update X_out, seq, enqueue.

        `pay` is the (len(peers), P) Send payload K - X_in when the caller
        already ran the full test (`_rules` returns it); recomputed here
        only for the unconditional-alert path.
        """
        if peers.size == 0:
            return
        alive = ~self.dead[peers]
        if not alive.all():  # crashed peers are silent — no sends, ever
            peers, dirs = peers[alive], dirs[alive]
            pay = pay[alive] if pay is not None else None
            if peers.size == 0:
                return
        st = self.state
        if pay is None:
            k = st.knowledge(peers)
            pay = k - st.X_in[peers, dirs]  # X_{i,v} = K_i - X_{v,i}
        st.X_out[peers, dirs] = pay
        st.seq[peers] += 1
        seqs = st.seq[peers]
        valid, origin, dest, edge, has_edge = R.send_batch(
            self.ring, peers, dirs, pos=self.pos
        )
        v = np.nonzero(valid)[0]
        # invalid (structurally absent) directions are silently wasted, as in
        # the paper; X_out is still updated, which is harmless since X_in
        # stays (0,...,0) for those directions.
        self.msgs.enqueue(
            origin[v], dest[v], edge[v], has_edge[v], pay[v], seqs[v],
            random_delays(self.rng, v.size, self.t),
        )

    def _react(self, idx: Optional[np.ndarray] = None):
        """test() on (a subset of) peers; Send with the payloads the same
        rule evaluation already produced."""
        viol, _, pay = self.state._rules(idx)
        p, dd = np.nonzero(viol)
        peers = p if idx is None else idx[p]
        self._send(peers, dd, pay=pay[p, dd])

    def _trigger_all_initial(self):
        self._react()

    # -- external events ----------------------------------------------------
    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray):
        """Input change upcall: set the peers' own data and re-run test().
        `new_votes` is (k,) scalar data or (k, D) vectors in RAW units —
        quantized here through the problem, exactly like `join`."""
        self.state.data[idx] = self.problem.init_state(np.asarray(new_votes))
        self.dirty = True
        self._react(idx)

    def alert(self, peers: np.ndarray, dirs: np.ndarray):
        """Alg. 2 ALERT upcall: zero X_in[v], send unconditionally, then
        test() — zeroing changes K, which can open violations in the
        *other* directions (an ALERT is an Alg. 3 event source like any
        receive; skipping the test wedges quiescence)."""
        self.state.X_in[peers, dirs] = 0
        self.state.last[peers, dirs] = 0
        # an ALERT is fresh news about the link: the failure detector must
        # not evict the *new* occupant on stamps aged against the old one
        self.heard[peers, dirs] = self.t
        self.dirty = True
        self._send(peers, dirs)
        self._react(np.unique(np.asarray(peers)))

    # -- churn (Alg. 2 tree change notification) ----------------------------
    def join(self, addr: int, vote=0) -> int:
        """A peer joins at `addr`: grow the ring and state, route the
        Alg. 2 ALERTs on the post-change ring, fire the upcalls.

        In-flight messages carry addresses, not peer indices, so the next
        delivery re-resolves ownership against the changed ring (the
        paper's DHT does the same); only traffic originating from the two
        changed tree positions is fenced (see `_apply_change`). Returns
        the new peer's ring index. `vote` is the joiner's scalar data or
        (D,) vector.
        """
        ring_before = self.ring
        ring_after, new_idx = ring_before.join(int(addr))
        st = self.state
        st.data = np.insert(st.data, new_idx,
                            self.problem.peer_data(vote), axis=0)
        st.X_in = np.insert(st.X_in, new_idx, 0, axis=0)
        st.X_out = np.insert(st.X_out, new_idx, 0, axis=0)
        st.seq = np.insert(st.seq, new_idx, 0)
        st.last = np.insert(st.last, new_idx, 0, axis=0)
        st.n += 1
        # joiner's detector stamps start at *now* — zeros would read as
        # `t` cycles of silence and evict its brand-new neighbors
        self.heard = np.insert(self.heard, new_idx, self.t, axis=0)
        self.probed = np.insert(self.probed, new_idx, self.t, axis=0)
        self.dead = np.insert(self.dead, new_idx, False)
        self.ring = ring_after
        self.pos = ring_after.positions()
        self._apply_change(N.join_event(ring_after, new_idx))
        return new_idx

    def leave(self, idx: int):
        """Peer `idx` departs: shrink the ring and state, route the Alg. 2
        ALERTs on the post-change ring, fire the upcalls. Its in-flight
        messages are fenced out of the network (`_apply_change`)."""
        if self.state.n <= 1:
            raise ValueError("cannot leave the last peer")
        if not 0 <= idx < self.state.n:  # match the device engine's guard
            raise IndexError(f"peer index {idx} out of range [0, {self.state.n})")
        ring_before = self.ring
        ring_after = ring_before.leave(idx)
        st = self.state
        st.data = np.delete(st.data, idx, axis=0)
        st.X_in = np.delete(st.X_in, idx, axis=0)
        st.X_out = np.delete(st.X_out, idx, axis=0)
        st.seq = np.delete(st.seq, idx)
        st.last = np.delete(st.last, idx, axis=0)
        st.n -= 1
        self.heard = np.delete(self.heard, idx, axis=0)
        self.probed = np.delete(self.probed, idx, axis=0)
        self.dead = np.delete(self.dead, idx)
        self.ring = ring_after
        self.pos = ring_after.positions()
        self._apply_change(N.leave_event(ring_after, ring_before, idx))

    def crash(self, idx: int):
        """Abrupt failure: peer `idx` vanishes silently — its state rows
        zero, in-flight messages it owns die, and *no* Alg. 2
        notification fires. The ring keeps the address until the
        neighbors' failure detectors synthesize the leave
        (`_fault_tick`), which is the whole point of the fault plane."""
        if self.faults is None:
            raise RuntimeError(
                "crash() requires an armed fault plane (faults=FaultConfig())")
        if self.state.n <= 1:
            raise ValueError("cannot crash the last peer")
        if not 0 <= idx < self.state.n:
            raise IndexError(f"peer index {idx} out of range [0, {self.state.n})")
        if self.dead[idx]:
            raise ValueError(f"peer {idx} already crashed")
        st = self.state
        self.dead[idx] = True
        st.data[idx] = 0
        st.X_in[idx] = 0
        st.X_out[idx] = 0
        st.seq[idx] = 0
        st.last[idx] = 0
        self.dirty = True
        # in-flight messages whose next hop the crashed peer owns die
        # with it (nobody is left to perform that DELIVER step)
        m = self.msgs
        live = np.nonzero(m.deliver_t >= 0)[0]
        if live.size:
            owners = np.asarray(self.ring.owner(m.dest[live]))
            m.release(live[owners == idx], lost=True)

    def _apply_change(self, ev: "N.ChurnEvent"):
        """Common tail of join/leave, keeping every changed tree link
        *bilaterally* refreshed:

        1. charge the synchronous alert routing to the message counter;
        2. fence (repair R3) — drop in-flight messages originating from
           the two change positions: their occupant is new, moved or
           gone, and a stale pre-change message arriving after the alert
           reset would wedge the per-(peer,dir) seq dedup against the
           new sender. Every fenced message is superseded by the
           unconditional re-sends of step 3;
        3. the *movers* — post-change peers whose tree position IS
           pos_fix / pos_var — zero all their X_in and send
           unconditionally in every direction. Each of their incident
           links has the routed ALERT of step 4 accepting at exactly
           its far endpoint (Lemma 2), so both ends of every changed
           link reset: the no-violation-implies-correct quiescence
           argument needs X_in_i = X_out_j per link, and a unilateral
           zero would silently break it;
        4. the routed notifications fire the paper's ALERT upcall (zero
           X_in[v], Send(v)) at the far endpoints.
        """
        self.messages_sent += ev.deliveries
        self.dirty = True  # membership changed: outputs re-indexed
        dt = self.ring.addrs.dtype
        fence = np.asarray([ev.pos_fix, ev.pos_var], dt)
        m = self.msgs
        stale = (m.deliver_t >= 0) & np.isin(m.origin, fence)
        m.release(np.nonzero(stale)[0])
        owners = self.ring.owner(fence)
        for p, o in zip(fence, owners):
            if int(self.pos[o]) == int(p):  # position occupied -> a mover
                self.alert(np.full(NDIR, o, np.int64),
                           np.arange(NDIR, dtype=np.int64))
        if ev.notifs:
            peers = np.asarray([p for p, _ in ev.notifs], np.int64)
            dirs = np.asarray([v for _, v in ev.notifs], np.int64)
            self.alert(peers, dirs)

    # -- cycle --------------------------------------------------------------
    def step(self):
        """One simulation cycle: deliver due messages (through the fault
        plane when armed), route, accept, react, then run the failure
        detector (probes + evictions)."""
        t = self.t
        m = self.msgs
        due = m.due(t)
        if due.size and self.faults is not None:
            f = self.faults
            # a hop handled by a crashed owner dies with it
            owners = np.asarray(self.ring.owner(m.dest[due]))
            lost = self.dead[owners]
            is_data = m.kind[due] == KIND_DATA
            # injected message faults hit the data plane only: probes and
            # the (synchronous) Alg. 2 control traffic stay reliable so
            # membership truth never forks between backends
            if f.p_drop > 0.0:
                lost |= is_data & (self.frng.random(due.size) < f.p_drop)
            delayed = np.zeros(due.size, bool)
            if f.p_delay > 0.0:
                delayed = (is_data & ~lost
                           & (self.frng.random(due.size) < f.p_delay))
            if lost.any():
                m.release(due[lost], lost=True)
            if delayed.any():
                di = due[delayed]
                m.deliver_t[di] = random_delays(self.frng, di.size, t)
            due = due[~lost & ~delayed]
        if due.size:
            status, owner, nd, ne, nhe = R.step_batch(
                self.ring, m.origin[due], m.dest[due], m.edge[due],
                m.has_edge[due], pos=self.pos,
            )
            self.messages_sent += due.size  # each delivery = one network msg
            fwd = status == R.FORWARD
            acc = status == R.ACCEPT
            # dropped messages free their table slot immediately
            self.msgs.release(due[status == R.DROP])
            # forwarded messages re-enter the network with a fresh delay;
            # probes ride the 1-cycle/hop control plane like device ALERTs
            fi = due[fwd]
            m.dest[fi] = nd[fwd]
            m.edge[fi] = ne[fwd]
            m.has_edge[fi] = nhe[fwd]
            dl = random_delays(self.rng, fi.size, t)
            if self.faults is not None:
                dl = np.where(m.kind[fi] == KIND_PROBE, t + 1, dl)
            m.deliver_t[fi] = dl
            # accepted messages update X_in with seq dedup
            ai = due[acc]
            if ai.size:
                self.dirty = True
                recv = owner[acc]
                vdir = A.direction_of(m.origin[ai], self.pos[recv], self.ring.d)
                vdir = np.asarray(vdir, np.int64)
                # every accept — data, duplicate or probe — is proof of
                # life on that link
                self.heard[recv, vdir] = t
                probe = m.kind[ai] == KIND_PROBE
                if probe.any():
                    # a probe carries no payload; the ack is an ordinary
                    # unconditional Send(v) — anti-entropy that also
                    # repairs whatever state the drop faults destroyed
                    m.release(ai[probe])
                    self._send(recv[probe], vdir[probe])
                    ai, recv, vdir = ai[~probe], recv[~probe], vdir[~probe]
            if ai.size:
                seqs = m.seq[ai]
                # resolve multiple same-(peer,dir) deliveries: ascending-seq
                # write order makes the newest message win
                order = np.argsort(seqs, kind="stable")
                st = self.state
                ok = seqs[order] > st.last[recv[order], vdir[order]]
                oo = order[ok]
                st.X_in[recv[oo], vdir[oo]] = m.pay[ai][oo]
                st.last[recv[oo], vdir[oo]] = seqs[oo]
                self.msgs.release(ai)
                # react: test() on affected peers
                self._react(np.unique(recv))
        if self.faults is not None:
            self._fault_tick(t)
        self.t += 1

    # -- failure detector (fault plane) ---------------------------------------
    def _monitored_links(self):
        """Module-level `monitored_links` on the current ring (shared
        with the device backends' boundary eviction sweep)."""
        return monitored_links(self.ring, self.pos, self.dead)

    def _resolve_far(self, peers: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """Module-level `resolve_far` on the current ring (shared with
        the device backends' boundary eviction sweep)."""
        return resolve_far(self.ring, self.pos, peers, dirs)

    def _fault_tick(self, t: int):
        """Per-cycle failure-detector pass: emit R3-fenced probes on
        suspected links; locally synthesize the Alg. 2 leave for the
        first-dark-hop accused peer once links go silent past
        `evict_after` (`elect_eviction` — lowest address first, fresh
        peers immune: the same deterministic election the device
        backends run)."""
        f = self.faults
        peers, dirs, monitored = self._monitored_links()
        probe, _ = P.suspicion_rules(self.heard.ravel(),
                                     self.probed.ravel(), t,
                                     f.suspect_after, f.evict_after)
        pm = probe & monitored
        if pm.any():
            self._probe(peers[pm], dirs[pm], t)
        if not f.evict_after:
            return
        while self.state.n > 1:
            # the grace floor defers convictions (not probes) after an
            # eviction so re-healed routes get one probe round first
            heff = np.maximum(self.heard, self._evict_floor)
            _, evict = P.suspicion_rules(heff.ravel(),
                                         self.probed.ravel(), t,
                                         f.suspect_after, f.evict_after)
            if not (evict & monitored).any():
                break
            target = elect_eviction(self.ring, self.pos, peers, dirs,
                                    monitored, evict, heff.ravel(),
                                    eviction_grace(self.state.n,
                                                   f.suspect_after))
            if target < 0:
                break
            self.evictions.append((t, int(self.ring.addrs[target])))
            self.leave(target)  # Alg. 2 verbatim: eviction IS a leave
            self._evict_floor = t - f.evict_after + eviction_grace(
                self.state.n, f.suspect_after)
            peers, dirs, monitored = self._monitored_links()

    def _probe(self, peers: np.ndarray, dirs: np.ndarray, t: int):
        """Emit liveness probes on the given links: empty-payload
        messages on the reliable 1-cycle/hop plane, seq-invisible (they
        never touch the data dedup), origin-fenced by R3 like any other
        traffic from a changed position."""
        valid, origin, dest, edge, has_edge = R.send_batch(
            self.ring, peers, dirs, pos=self.pos)
        v = np.nonzero(valid)[0]
        pw = self.problem.payload_width
        self.msgs.enqueue(
            origin[v], dest[v], edge[v], has_edge[v],
            np.zeros((v.size, pw), np.int64), np.zeros(v.size, np.int64),
            np.full(v.size, t + 1, np.int64), kind=KIND_PROBE,
        )
        self.probed[peers, dirs] = t

    # -- experiment helpers ---------------------------------------------------
    def run_until_converged(
        self, truth: int, max_cycles: int = 200_000, stable_for: int = 1
    ) -> Dict[str, float]:
        """Run until every peer outputs `truth` (paper: first such cycle)."""
        start_msgs = self.messages_sent
        stable = 0
        for _ in range(max_cycles):
            conv = self.problem.converged(np, self.state.outputs(), truth)
            if conv[~self.dead].all():
                stable += 1
                if stable >= stable_for:
                    return {
                        "cycles": self.t,
                        "messages": self.messages_sent - start_msgs,
                        "converged": 1.0,
                        "invalid": 0.0,  # the host table grows, never drops
                    }
            else:
                stable = 0
            self.step()
        return {
            "cycles": self.t,
            "messages": self.messages_sent - start_msgs,
            "converged": 0.0,
            "invalid": 0.0,
        }
