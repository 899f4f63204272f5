"""Numpy oracle engine — the port's host ground truth.

Copied from `repro.engine.numpy_backend`: a thin adapter putting the
cycle-exact simulator (`core.majority.MajoritySimulator`, host numpy,
growing message table, `np.random` delays) behind the `MajorityEngine`
API. Protocol rules are the shared functions of `engine.protocol`, so a
divergence between this backend and `TorchEngine` can only come from the
simulation harness (RNG, table mechanics), never from the rules.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dht import Ring
from repro_torch.core.majority import MajoritySimulator
from repro_torch.engine.base import (EngineResult, coalesced_update,
                               run_convergence_loop)
from repro_torch.engine.problems import get_problem


class NumpyEngine:
    """Host-backed `MajorityEngine` (see `engine.base`)."""

    backend = "numpy"

    def __init__(self, ring: Ring, votes: np.ndarray, seed: int = 0,
                 problem=None, faults=None):
        self.ring = ring
        self.problem = get_problem(problem)
        self.faults = faults
        self.sim = MajoritySimulator(ring, votes, seed=seed,
                                     problem=self.problem, faults=faults)

    @property
    def t(self) -> int:
        return self.sim.t

    @property
    def messages_sent(self) -> int:
        return self.sim.messages_sent

    @property
    def in_flight(self) -> int:
        return self.sim.msgs.in_flight

    @property
    def dropped(self) -> int:
        """Messages lost to table overflow — always 0 here: the host
        table grows on demand (API symmetry with TorchEngine)."""
        return 0

    @property
    def lost_to_fault(self) -> int:
        """Messages destroyed by the injected fault plane (crashes +
        `FaultConfig.p_drop`), itemized apart from `dropped`."""
        return self.sim.msgs.lost

    @property
    def evictions(self):
        """[(cycle, address), ...] leaves the failure detector synthesized."""
        return list(self.sim.evictions)

    def dead_mask(self) -> np.ndarray:
        """(n,) bool — crashed peers the detector has not yet evicted."""
        return self.sim.dead.copy()

    def last_heard(self) -> np.ndarray:
        """(n,) cycle each peer's links last carried inbound traffic —
        the per-peer heartbeat of the fault plane."""
        return self.sim.heard.max(axis=1).copy()

    def check_conservation(self) -> None:
        """Exact message-table ledger: every message ever enqueued is
        retired, in flight, or itemized as lost to an injected fault —
        injected faults stay distinguishable from engine bugs."""
        m = self.sim.msgs
        balance = m.retired + m.lost + m.in_flight
        assert m.enqueued == balance, (
            f"ledger leak: enqueued={m.enqueued} != retired={m.retired} + "
            f"lost_to_fault={m.lost} + in_flight={m.in_flight}")

    def outputs(self) -> np.ndarray:
        return self.sim.state.outputs()

    def votes(self) -> np.ndarray:
        return self.sim.state.x.copy()

    def data(self) -> np.ndarray:
        """(n, D) quantized per-peer data plane (problem layer)."""
        return self.sim.state.data.copy()

    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray) -> None:
        self.sim.set_votes(np.asarray(idx), np.asarray(new_votes))

    def apply_coalesced(self, idx: np.ndarray, new_data: np.ndarray) -> int:
        """Serve-layer flush (one coalesced batch -> one batched
        `set_votes`; see `engine.base`)."""
        idx, vals = coalesced_update(idx, new_data, self.ring.n)
        if idx.size:
            self.sim.set_votes(idx, vals)
        return int(idx.size)

    def alert(self, peers: np.ndarray, dirs: np.ndarray) -> None:
        """Raw Alg. 2 ALERT upcall (join/leave call this internally)."""
        self.sim.alert(peers, dirs)

    def join(self, addr: int, vote: int = 0) -> int:
        """Membership upcall: a peer joins at `addr` (Alg. 2)."""
        new_idx = self.sim.join(addr, vote=vote)
        self.ring = self.sim.ring
        return new_idx

    def leave(self, idx: int) -> None:
        """Membership upcall: peer `idx` departs (Alg. 2)."""
        self.sim.leave(idx)
        self.ring = self.sim.ring

    def crash(self, idx: int) -> None:
        """Abrupt-failure upcall: peer `idx` vanishes silently (no
        Alg. 2 notification) — requires an armed fault plane."""
        self.sim.crash(idx)
        self.ring = self.sim.ring

    def step(self, cycles: int = 1) -> None:
        for _ in range(cycles):
            self.sim.step()
        self.ring = self.sim.ring  # evictions may have shrunk the ring

    def block_until_ready(self) -> None:  # API symmetry with TorchEngine
        pass

    def _converged(self, truth: int) -> bool:
        """Convergence check with a dirty-flag cache: `outputs()` walks
        every peer's knowledge, so only recompute it when an event since
        the last check could actually have moved an output (message
        accepted, vote set, churn). Quiet cycles — the long tail of any
        run-to-quiescence — cost one flag read instead of an O(n) scan
        per cycle (the old per-cycle double dispatch of this path)."""
        if self.sim.dirty or self._conv_truth != truth:
            conv = self.problem.converged(np, self.sim.state.outputs(), truth)
            # crashed-but-unevicted peers have no say in convergence
            self._conv_cache = bool(conv[~self.sim.dead].all())
            self._conv_truth = truth
            self.sim.dirty = False
        return self._conv_cache

    def run_until_converged(self, truth: int, max_cycles: int = 200_000,
                            stable_for: int = 1) -> EngineResult:
        self._conv_truth = None
        start_msgs = self.messages_sent
        state = {"stable": 0}

        def probe(budget: int):
            for i in range(budget):
                if self._converged(truth):
                    state["stable"] += 1
                    if state["stable"] >= stable_for:
                        return True, i + 1
                else:
                    state["stable"] = 0
                self.sim.step()
            return False, budget

        return run_convergence_loop(
            probe, max_cycles,
            cycles=lambda: self.t,
            messages=lambda: self.messages_sent - start_msgs,
        )
