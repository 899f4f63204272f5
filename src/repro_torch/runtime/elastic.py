"""Elastic membership via the paper's protocols (DESIGN.md §2).

The port's copy of `repro.runtime.elastic`, over the port's ring, Alg. 2
and engines: the drills run `make_engine` with ``backend="torch"`` (on
CUDA unless ``device=`` names another device) or ``"numpy"``.

Hosts/pods are peers on a virtual ring: host h gets address h * 2^d / H.
The binary-tree position algebra then gives every host its control-tree
neighbors (UP/CW/CCW) *locally* — no membership service — and Alg. 2 tells
us exactly which hosts must re-wire when one joins or leaves (≤ 5, Lemma 5).

This module drives the *control plane*: the data plane (mesh shapes for
XLA) still needs a full re-compile on membership change, but the control
tree survives arbitrary churn with O(1) local updates — it is what carries
heartbeats, violation votes (threshold_sync) and straggler reports between
sync points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import addressing as A
from repro_torch.core import notify as N
from repro_torch.core.dht import Ring

D_BITS = 32


@dataclasses.dataclass
class Membership:
    """Current host set, as a ring of equally-spaced addresses."""

    host_ids: List[int]  # stable, sorted host identifiers

    def ring(self) -> Ring:
        # equal spacing by rank keeps the tree perfectly balanced for 2^k
        n = len(self.host_ids)
        spacing = (1 << D_BITS) // n
        addrs = (np.arange(n, dtype=np.uint64) * np.uint64(spacing))
        return Ring(addrs, D_BITS)

    def tree_neighbors(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ring = self.ring()
        return A.tree_neighbors_reference(ring.addrs, D_BITS)

    def affected_by_leave(self, host_rank: int) -> List[int]:
        """Ranks whose control-tree neighbors change if `host_rank` leaves
        (computed via Alg. 2 on the post-change ring)."""
        ring = self.ring()
        after = ring.leave(host_rank)
        notifs = N.notify_leave(after, ring, host_rank)
        # post-ring indices >= host_rank shift by +1 back to pre-ring ranks
        return sorted({p if p < host_rank else p + 1 for p, _ in notifs})

    def affected_by_join(self) -> List[int]:
        """Ranks alerted when a new host joins at the end of the ring."""
        ring = self.ring()
        new_addr = int(ring.addrs[-1]) + (A.mask_of(D_BITS) - int(ring.addrs[-1])) // 2
        after, new_idx = ring.join(new_addr)
        notifs = N.notify_join(after, new_idx)
        return sorted({p for p, _ in notifs})


def churn_drill(hosts: int = 32, events: int = 8, backend: str = "torch",
                seed: int = 0, spacing: int = 25,
                max_cycles: int = 50_000, device=None, **engine) -> Dict:
    """Live churn rehearsal on a real engine (not just the Lemma-5 math):
    run majority voting over `hosts` peers, fire `events` interleaved
    join/leave upcalls mid-run (Alg. 2 ALERTs, fence, bilateral link
    resets — DESIGN.md §Churn), then measure re-convergence to the true
    majority of the surviving vote set.

    This is the control-plane story for elastic training: host failures
    and arrivals re-wire the monitoring tree with O(1) local updates
    while the violation votes keep flowing. Returns cycle/message
    accounting the example and benchmarks print.

    ``device`` and the keyword arguments in `engine` (e.g.
    ``wheel_kernels="none"``, ``capacity_per_peer``) go to the torch
    engine (`engine.make_engine`).
    """
    from repro_torch.core.churn import random_schedule

    rng = np.random.default_rng(seed)
    ring = Ring.random(hosts, D_BITS, seed=seed)
    votes = (rng.random(hosts) < 0.4).astype(np.int64)
    eng = _engine(backend, ring, votes, seed + 1, device, engine)
    truth0 = int(2 * votes.sum() >= votes.size)
    warm = eng.run_until_converged(truth=truth0, max_cycles=max_cycles)
    sched = random_schedule(ring, events, seed + 2, n_min=4, spacing=spacing)
    sched.apply(eng)
    joins = sum(1 for op in sched.ops if op[0] == "join")
    leaves = events - joins
    v = eng.votes()
    truth = int(2 * v.sum() >= v.size)
    t0, m0 = eng.t, eng.messages_sent
    res = eng.run_until_converged(truth=truth, max_cycles=max_cycles)
    return {
        "backend": backend,
        "hosts_start": hosts, "hosts_end": int(eng.ring.n),
        "joins": joins, "leaves": leaves,
        "warmup_cycles": warm["cycles"],
        "reconverge_cycles": int(res["cycles"] - t0),
        "reconverge_messages": int(eng.messages_sent - m0),
        "total_messages": int(eng.messages_sent),
        "converged": res["converged"],
        "invalid": res.get("invalid", 0.0),
    }


def decision_latency_profile(hosts: int = 32, trials: int = 16,
                             backend: str = "torch", seed: int = 0,
                             mu: float = 0.55,
                             max_cycles: int = 50_000,
                             trace: Optional[Sequence[Dict]] = None,
                             device=None, **engine) -> Dict:
    """How fast does the control tree decide a sync quorum? — `trials`
    independent majority votes over `hosts` peers, run to convergence as
    ONE batched engine (`make_engine(..., batch=trials)`: on the torch
    backend a `BatchedTorchEngine`, each wheel kernel launched once a
    cycle for all trials; ``device`` and `engine` as in `churn_drill`).

    This is the threshold-sync control-plane question at fleet scale:
    every sync decision (`EngineQuorum` in benchmarks/sync_comparison)
    is one such majority vote, and the trainer's staleness deadline
    (`max_inner_steps`) must cover its latency tail. Returns the cycle
    and per-peer message distribution across trials.

    With ``trace=`` the synthetic quorum draws are skipped entirely and
    the profile is computed from a REAL serve trace
    (`repro_torch.launch.serve.ThresholdServer.trace`, or the load harness's
    recorded copy): each ``settle`` record is one disturbance epoch —
    opened at the flush/churn boundary that broke convergence, closed at
    the first window boundary where every peer again outputs the
    ground-truth decision of the live data plane (DESIGN.md §11 latency
    accounting). The tails are reported both in engine cycles and in
    harness wall milliseconds; a trace with no settle records (nothing
    ever disturbed convergence — e.g. an all-converged no-op run)
    degrades to zero-decision output instead of crashing."""
    if trace is not None:
        return _profile_from_trace(trace)

    rings = Ring.random(hosts, D_BITS, seed=seed)
    votes = np.stack([
        (np.random.default_rng(seed + 100 + b).random(hosts) < mu)
        .astype(np.int64)
        for b in range(trials)
    ])
    truths = (2 * votes.sum(1) >= hosts).astype(np.int64)
    eng = _engine(backend, rings, votes, seed + 1, device, engine,
                  batch=trials)
    results = eng.run_until_converged(truths, max_cycles=max_cycles)
    cycles = np.asarray([r["cycles"] for r in results], np.float64)
    msgs = np.asarray([r["messages"] for r in results], np.float64) / hosts
    return {
        "backend": backend, "hosts": hosts, "trials": trials,
        "converged": float(np.mean([r["converged"] for r in results])),
        "cycles_p50": float(np.percentile(cycles, 50)),
        "cycles_p95": float(np.percentile(cycles, 95)),
        "cycles_max": float(cycles.max()),
        "msgs_per_peer_p50": float(np.percentile(msgs, 50)),
        "msgs_per_peer_p95": float(np.percentile(msgs, 95)),
    }


def _engine(backend: str, ring, votes, seed, device, engine: Dict, **kw):
    """`make_engine` with the torch engine's device and arguments (the
    numpy oracle takes neither)."""
    from repro_torch.engine import make_engine

    if backend == "torch":
        kw.update(engine, device=device)
    elif engine:
        raise ValueError(f"engine arguments {sorted(engine)} are the torch "
                         f"engine's; backend {backend!r} takes none")
    return make_engine(backend, ring, votes, seed=seed, **kw)


def _profile_from_trace(trace: Sequence[Dict]) -> Dict:
    """Decision-latency tails from serve `settle` epochs (see
    `decision_latency_profile(trace=...)`)."""
    settles = [r for r in trace if r.get("kind") == "settle"]
    flushes = sum(1 for r in trace if r.get("kind") == "flush")
    transitions = sum(1 for r in trace if r.get("kind") == "transition")
    out = {
        "source": "serve_trace",
        "decisions": len(settles),
        "flushes": flushes,
        "transitions": transitions,
    }
    if not settles:
        return {**out, "converged": 1.0,
                "cycles_p50": 0.0, "cycles_p95": 0.0, "cycles_p99": 0.0,
                "cycles_max": 0.0, "ms_p50": 0.0, "ms_p95": 0.0,
                "ms_p99": 0.0, "ms_max": 0.0}
    cycles = np.asarray([r["cycles"] for r in settles], np.float64)
    ms = np.asarray([r["wall_ms"] for r in settles], np.float64)
    out["converged"] = 1.0  # an epoch only enters the trace once it closed
    for name, a in (("cycles", cycles), ("ms", ms)):
        for p in (50, 95, 99):
            out[f"{name}_p{p}"] = float(np.percentile(a, p))
        out[f"{name}_max"] = float(a.max())
    return out


def remesh_plan(old_hosts: int, new_hosts: int, dp: int, tp: int) -> Dict:
    """Recompute the (data, model) mesh after churn.

    Keeps TP intact (model-parallel groups must be co-located) and shrinks/
    grows the DP axis; returns the plan the trainer uses to rebuild meshes
    and re-shard the checkpoint (ckpt.restore handles the data movement).
    """
    assert new_hosts * dp * tp > 0
    new_dp = max(1, dp * new_hosts // max(old_hosts, 1))
    return {
        "old": {"hosts": old_hosts, "dp": dp, "tp": tp},
        "new": {"hosts": new_hosts, "dp": new_dp, "tp": tp},
        "recompile": True,
        "reshard_via_checkpoint": True,
    }
