"""Seeded churn schedules (join/leave/crash event streams), host numpy.

Copied from `repro.core.churn`: `random_schedule` evolves a shadow copy
of the ring through exactly the ops a caller will apply, and each event's
post-change snapshot carries the Alg. 2 (a_im2, a_im1, a_i) triple;
`ChurnSchedule.apply` replays the ops on an engine and checks after every
event that the engine's ring still equals the shadow ring. Crashes
(`p_crash` / `range_fail`) keep their address in the shadow ring until a
failure detector evicts it, so they replay on an engine armed with a
fault plane (``faults=``), drift-free while no eviction lands mid-gap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np

from . import addressing as A
from .dht import Ring

JoinOp = Tuple[str, int, int]  # ("join", addr, vote)
LeaveOp = Tuple[str, int]      # ("leave", idx)
CrashOp = Tuple[str, int]      # ("crash", idx)
Snap = Tuple[Ring, int, int, int]  # (ring_after, a_im2, a_im1, a_i)


@dataclass(frozen=True)
class ChurnSchedule:
    ops: List[Union[JoinOp, LeaveOp, CrashOp]]
    gaps: np.ndarray  # (events,) cycles to run after each op
    snaps: List[Snap]

    def apply(self, eng, step: bool = True) -> None:
        """Replay the schedule on a `MajorityEngine`.

        Every op's index/address was resolved against the generator's
        shadow ring, so the engine ring must track it exactly; after
        each event the two are compared and a mismatch raises with the
        divergent event named (the old behaviour — a bare IndexError
        from whatever op happened to land out of range *later* — pointed
        at the victim, not the cause). Crashes keep their address in
        both rings until the engine's detector evicts it; an eviction
        mid-gap is precisely the drift this check reports.
        """
        for i, (op, gap, snap) in enumerate(zip(self.ops, self.gaps,
                                                self.snaps)):
            if op[0] == "join":
                eng.join(op[1], vote=op[2])
            elif op[0] == "leave":
                eng.leave(op[1])
            else:
                eng.crash(op[1])
            want = snap[0].addrs
            got = np.asarray(eng.ring.addrs)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise RuntimeError(
                    f"engine ring diverged from the schedule's shadow ring "
                    f"at event {i} ({op!r}): engine n={got.size} vs shadow "
                    f"n={want.size} — a failure-detector eviction (or an op "
                    f"applied out of order) changed membership the schedule "
                    f"did not model; replay crash schedules with "
                    f"evict_after=0 or regenerate against the evicted ring")
            if step:
                eng.step(int(gap))


def random_schedule(ring0: Ring, events: int, seed: int, *,
                    p_leave: float = 0.5, p_crash: float = 0.0,
                    n_min: int = 8, spacing: int = 25,
                    mean_gap: float = 0.0, mass_join: int = 0,
                    range_fail: int = 0) -> ChurnSchedule:
    """Interleaved join/leave/crash events against a shadow copy of `ring0`.

    Joins draw fresh d-bit addresses; leaves pick a uniform live
    (never crashed) index but are suppressed below `n_min` alive peers;
    crashes (probability `p_crash`) pick like leaves but keep the
    address in the shadow ring — discovery is the detector's job. Gaps
    are the constant `spacing` unless `mean_gap` > 0, which draws
    exponential (Poisson-process) inter-event gaps instead.

    Bursts: `mass_join` > 0 injects that many back-to-back joins (zero
    gap) halfway through the stream; `range_fail` > 0 crashes that many
    ring-contiguous peers in one zero-gap burst at the two-thirds point
    — the paper's mass-churn reconvergence scenarios.
    """
    rng = np.random.default_rng(seed)
    occupied = set(int(a) for a in ring0.addrs)
    dead: set = set()
    r = ring0
    ops: List[Union[JoinOp, LeaveOp, CrashOp]] = []
    snaps: List[Snap] = []
    gaps: List[int] = []

    def draw_gap() -> int:
        if mean_gap > 0:
            return max(1, int(rng.exponential(mean_gap)))
        return int(spacing)

    def fresh_addr() -> int:
        while True:
            a = int(rng.integers(0, A.mask_of(ring0.d)))
            if a not in occupied:
                return a

    def do_join(gap: int):
        nonlocal r
        a = fresh_addr()
        occupied.add(a)
        r, k = r.join(a)
        n2 = r.n
        snaps.append((r, int(r.addrs[(k - 1) % n2]), a,
                      int(r.addrs[(k + 1) % n2])))
        ops.append(("join", a, int(rng.integers(0, 2))))
        gaps.append(gap)

    def pick_alive() -> int:
        cand = [i for i in range(r.n) if int(r.addrs[i]) not in dead]
        return cand[int(rng.integers(0, len(cand)))]

    def do_crash(idx: int, gap: int):
        nb = r.n
        dead.add(int(r.addrs[idx]))
        # delayed discovery: the ring keeps the address; the snap is the
        # Alg. 2 triple the eventual detector eviction will fire
        snaps.append((r, int(r.addrs[(idx - 1) % nb]), int(r.addrs[idx]),
                      int(r.addrs[(idx + 1) % nb])))
        ops.append(("crash", idx))
        gaps.append(gap)

    for e in range(events):
        if mass_join and e == events // 2:
            for j in range(mass_join):
                do_join(0 if j < mass_join - 1 else draw_gap())
        if range_fail and e == (2 * events) // 3:
            alive = r.n - len(dead)
            burst = min(range_fail, max(0, alive - max(2, n_min // 2)))
            if burst > 0:
                start = pick_alive()
                done = 0
                i = start
                while done < burst:
                    if int(r.addrs[i % r.n]) not in dead:
                        do_crash(i % r.n,
                                 0 if done < burst - 1 else draw_gap())
                        done += 1
                    i += 1
        u = rng.random()
        alive = r.n - len(dead)
        if u < p_leave and alive > n_min:
            li = pick_alive()
            before = r
            r = r.leave(li)
            nb = before.n
            snaps.append((r, int(before.addrs[(li - 1) % nb]),
                          int(before.addrs[li]),
                          int(before.addrs[(li + 1) % nb])))
            occupied.discard(int(before.addrs[li]))
            ops.append(("leave", li))
            gaps.append(draw_gap())
        elif u < p_leave + p_crash and alive > n_min:
            do_crash(pick_alive(), draw_gap())
        else:
            do_join(draw_gap())
    return ChurnSchedule(ops, np.asarray(gaps, dtype=int), snaps)
