"""Engine API plumbing shared with the reference (host numpy).

Copied from `repro.engine.base`: the result record, the serve layer's
flush-batch validation (`coalesced_update`), the run-to-quiescence loop
skeleton, the fault-plane configuration record and the engine protocol
(`MajorityEngine`) that `TorchEngine` and `NumpyEngine` implement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np

EngineResult = Dict[str, float]
# {"cycles", "messages", "converged", "invalid"} — `invalid` is 1.0 when
# the run lost messages to wheel overflow; rerun with a larger
# capacity_per_peer.


def coalesced_update(idx, new_data, n: int):
    """Validate one ingestion-ring flush batch: `idx` strictly ascending
    in [0, n), one raw data row per index. Returns (int64 idx, data)."""
    idx = np.asarray(idx, np.int64)
    vals = np.asarray(new_data)
    if idx.ndim != 1:
        raise ValueError(f"coalesced idx must be 1-D, got shape {idx.shape}")
    if vals.shape[:1] != idx.shape:
        raise ValueError(
            f"coalesced data rows {vals.shape} do not match idx {idx.shape}")
    if idx.size:
        if (np.diff(idx) <= 0).any():
            raise ValueError(
                "coalesced idx must be strictly ascending — last-writer-"
                "wins coalescing leaves exactly one value per peer")
        if idx[0] < 0 or idx[-1] >= n:
            raise IndexError(
                f"coalesced idx out of range [0, {n}): "
                f"[{idx[0]}, {idx[-1]}]")
    return idx, vals


@dataclass(frozen=True)
class FaultConfig:
    """Deterministic fault-plane configuration (crashes, seeded message
    drops/delays, the timeout failure detector)."""

    p_drop: float = 0.0
    p_delay: float = 0.0
    suspect_after: int = 40
    evict_after: int = 0
    seed: int = 0

    def __post_init__(self):
        if not (0.0 <= self.p_drop <= 1.0 and 0.0 <= self.p_delay <= 1.0):
            raise ValueError("fault probabilities must lie in [0, 1]")
        if self.suspect_after < 1:
            raise ValueError("suspect_after must be >= 1")
        if self.evict_after < 0:
            raise ValueError("evict_after must be >= 0 (0 disables eviction)")
        if self.evict_after and self.evict_after <= self.suspect_after:
            raise ValueError("evict_after must exceed suspect_after")


def run_convergence_loop(
    probe: Callable[[int], Tuple[bool, int]],
    max_cycles: int,
    *,
    cycles: Callable[[], int],
    messages: Callable[[], int],
    invalid: Callable[[], float] = lambda: 0.0,
) -> EngineResult:
    """Up to `max_cycles` iterations of (convergence check; step), the
    check running before the step. `probe(budget)` advances by at most
    `budget` iterations and returns `(done, used)`."""
    remaining = int(max_cycles)
    done = False
    while remaining > 0 and not done:
        done, used = probe(remaining)
        remaining -= max(int(used), 1)
    return {
        "cycles": cycles(),
        "messages": messages(),
        "converged": 1.0 if done else 0.0,
        "invalid": invalid(),
    }


@runtime_checkable
class MajorityEngine(Protocol):
    """Cycle-driven Alg. 1 + Alg. 2 + Alg. 3 co-simulation over a
    dynamic ring."""

    backend: str  # "torch" | "numpy"

    @property
    def t(self) -> int:
        """Current simulation cycle."""

    @property
    def messages_sent(self) -> int:
        """Network deliveries consumed so far (the paper's message unit),
        Alg. 2 ALERT routing included."""

    @property
    def dropped(self) -> int:
        """Messages lost to table overflow. Always 0 for the numpy
        backend (its table grows); a device run with dropped > 0 is
        invalid and `run_until_converged` flags it."""

    @property
    def lost_to_fault(self) -> int:
        """Messages destroyed by the *injected* fault plane (crashes,
        `FaultConfig.p_drop`). Itemized separately from `dropped` so
        engine bugs stay distinguishable from injected faults:
        `check_conservation` asserts
        enqueued == retired + in_flight + dropped + lost_to_fault."""

    def outputs(self) -> np.ndarray:
        """(n,) current 0/1 output of every peer (n tracks churn)."""

    def votes(self) -> np.ndarray:
        """(n,) current scalar data of every peer (majority: the vote);
        (n, D) for problems with data_width > 1."""

    def data(self) -> np.ndarray:
        """(n, D) quantized per-peer data plane (problem layer)."""

    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray) -> None:
        """Data-change upcall: set X_self and re-run test() on `idx`;
        `new_votes` is (k,) scalar data or (k, D) vectors."""

    def apply_coalesced(self, idx: np.ndarray, new_data: np.ndarray) -> int:
        """Serve-layer flush upcall: apply one
        ingestion-ring batch — client updates coalesced last-writer-wins
        per peer since the previous superstep boundary — as a single
        batched `set_votes` riding the full-width event-react path.
        `idx` must be strictly ascending with one raw data row per
        index (`coalesced_update` validates); an empty batch is a no-op.
        Returns the number of peer rows applied. Uniform across the
        numpy and torch engines so the ingestion
        ring never needs backend branches."""

    def join(self, addr: int, vote: int = 0) -> int:
        """Membership upcall: a peer with `vote` joins at address `addr`
        (must be unoccupied). Emits the Alg. 2 ALERTs, re-routes
        in-flight traffic against the grown ring, and re-runs the
        Alg. 3 test on every affected peer. Returns the new peer's ring
        index (existing indices at or above it shift up by one)."""

    def leave(self, idx: int) -> None:
        """Membership upcall: peer `idx` departs. Emits the Alg. 2
        ALERTs on the shrunken ring; the departed peer's in-flight
        traffic is fenced. Indices above `idx` shift down by one.
        Raises ValueError on the last peer."""

    def step(self, cycles: int = 1) -> None:
        """Advance the simulation by `cycles` cycles."""

    def run_until_converged(self, truth: int, max_cycles: int = 200_000,
                            stable_for: int = 1) -> EngineResult:
        """Run until every peer outputs `truth` (checked each cycle,
        before stepping — the paper's 'first such cycle')."""
