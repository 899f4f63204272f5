"""Engine API plumbing shared with the reference (host numpy).

Copied from `repro.engine.base`: the result record, the serve layer's
flush-batch validation (`coalesced_update`), the run-to-quiescence loop
skeleton and the fault-plane configuration record (the fault plane
itself is a later slice; `TorchEngine` refuses ``faults=``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

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
