"""Failure detection, restart policy, straggler mitigation.

The port's copy of `repro.runtime.fault_tolerance` (host Python, no
device). On a real pod this sits in the per-host agent; here the same
logic is driven by the trainer (`launch.train.run_plain`'s restart loop)
and by the engines' in-protocol failure detector. The pieces:

  * HeartbeatMonitor — per-host last-seen timestamps over the control tree
    (a host's heartbeat travels UP the paper's binary tree: O(log H) hops,
    and a missing host is noticed by exactly its tree neighbors — Lemma 5
    keeps the blast radius of a membership change at <= 5 re-wires).
  * RestartPolicy — exponential backoff with a budget; decides
    resume-from-checkpoint vs abort.
  * StragglerTracker — per-host step-time EWMA; hosts slower than
    `ratio` x median are flagged. With threshold_sync the flagged host
    simply misses the vote window (the paper's "we prefer wasting those
    messages") instead of stalling the barrier; with plain DP the trainer
    excludes it at the next re-mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None):
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[int]:
        t = time.monotonic() if now is None else now
        return [h for h, s in self.last_seen.items() if t - s > self.timeout_s]


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    restarts: int = 0

    def next_delay(self) -> Optional[float]:
        """None => give up."""
        if self.restarts >= self.max_restarts:
            return None
        d = self.backoff_s * (self.backoff_mult ** self.restarts)
        self.restarts += 1
        return d

    def reset(self):
        self.restarts = 0


@dataclasses.dataclass
class StragglerTracker:
    alpha: float = 0.2
    ratio: float = 1.8
    ewma: Dict[int, float] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_time_s: float):
        prev = self.ewma.get(host)
        self.ewma[host] = (
            step_time_s if prev is None
            else (1 - self.alpha) * prev + self.alpha * step_time_s
        )

    def stragglers(self) -> List[int]:
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        return [h for h, t in self.ewma.items() if t > self.ratio * med]


@dataclasses.dataclass
class EngineSuspicionBridge:
    """Drives the host-agent primitives from the *in-protocol* failure
    detector instead of a separate heartbeat network.

    The engines' fault plane already tracks per-link `heard` stamps and
    synthesizes evictions (DESIGN.md §10); this bridge re-expresses
    those signals in the agent's vocabulary so one detector serves both
    layers: each peer's freshest inbound stamp becomes its heartbeat on
    the *cycle* clock (`HeartbeatMonitor.timeout_s` is then cycles, not
    seconds), and every detector eviction consumes one restart from the
    `RestartPolicy` budget — `sync` returns the planned
    [(address, delay_or_None)] rejoins, None once the budget is spent.

    Any of the port's engines serves: `TorchEngine`, `NumpyEngine` and
    `ShardedTorchEngine` (whose `last_heard` and `evictions` are the
    whole ring's on every rank) expose `last_heard()`, `evictions`,
    `ring` and `t`.
    """

    monitor: HeartbeatMonitor
    policy: RestartPolicy
    seen_evictions: int = 0

    def sync(self, eng) -> List:
        stamps = eng.last_heard()
        for a, s in zip(eng.ring.addrs, stamps):
            prev = self.monitor.last_seen.get(int(a))
            if prev is None or float(s) > prev:
                self.monitor.beat(int(a), now=float(s))
        plans = []
        for _, addr in eng.evictions[self.seen_evictions:]:
            self.monitor.last_seen.pop(int(addr), None)
            plans.append((int(addr), self.policy.next_delay()))
        self.seen_evictions = len(eng.evictions)
        return plans

    def suspects(self, eng) -> List[int]:
        """Addresses silent past the monitor's timeout, on the engine's
        cycle clock — the agent-level view of `P.suspicion_rules`."""
        return self.monitor.dead(now=float(eng.t))
