"""Cycle-driven network simulator (paper §4: peersim-equivalent harness).

Copied from `repro.core.simulator` for the port's host numpy layer.

Messages are held in a growing structure-of-arrays table. Each *network
delivery* (one DHT routing) costs a uniformly random delay of 1..10 cycles —
the paper uses the same range, "not to approximate wall time but rather to
decouple the peers and avoid locked-step behavior". Message counting is per
network delivery, which puts tree routing and gossip on equal footing.

This is the *host* (numpy) message fabric of the port's numpy oracle
(`engine.numpy_backend`). The device engine (`engine.torch_backend`)
keeps its rows in a fixed-capacity delivery wheel instead and shares
`MIN_DELAY`/`MAX_DELAY` from here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MIN_DELAY, MAX_DELAY = 1, 10
AVG_DELAY = (MIN_DELAY + MAX_DELAY) / 2  # "average message delay" = 5.5 ~ 5 cycles

KIND_DATA, KIND_PROBE = 0, 1  # probe = fault-plane liveness ping


@dataclass
class MessageTable:
    """Bounded-growth SoA message queue. The payload is a (capacity, P)
    int64 plane — P = problem payload width (`engine.problems`;
    the paper's majority messages are P = 2: ones, total)."""

    capacity: int = 1024
    payload_width: int = 2
    origin: np.ndarray = field(default=None)  # sender tree position
    dest: np.ndarray = field(default=None)  # destination address
    edge: np.ndarray = field(default=None)
    has_edge: np.ndarray = field(default=None)
    pay: np.ndarray = field(default=None)  # (capacity, P)
    seq: np.ndarray = field(default=None)
    deliver_t: np.ndarray = field(default=None)  # -1 == free slot
    kind: np.ndarray = field(default=None)  # KIND_DATA | KIND_PROBE
    addr_dtype: type = np.uint64
    # exact conservation ledger (enqueued == retired + lost + in_flight)
    enqueued: int = 0
    retired: int = 0
    lost: int = 0

    def __post_init__(self):
        c = self.capacity
        self.origin = np.zeros(c, self.addr_dtype)
        self.dest = np.zeros(c, self.addr_dtype)
        self.edge = np.zeros(c, self.addr_dtype)
        self.has_edge = np.zeros(c, bool)
        self.pay = np.zeros((c, self.payload_width), np.int64)
        self.seq = np.zeros(c, np.int64)
        self.deliver_t = np.full(c, -1, np.int64)
        self.kind = np.zeros(c, np.int8)

    @property
    def pay_ones(self) -> np.ndarray:
        """Majority payload column 0 (back-compat view)."""
        return self.pay[:, 0]

    @property
    def pay_total(self) -> np.ndarray:
        """Majority payload column 1 (back-compat view)."""
        return self.pay[:, 1]

    def _grow(self, need: int):
        newcap = max(self.capacity * 2, self.capacity + need)
        for name in ("origin", "dest", "edge", "has_edge", "pay", "seq",
                     "deliver_t", "kind"):
            old = getattr(self, name)
            new = np.zeros((newcap,) + old.shape[1:], old.dtype)
            if name == "deliver_t":
                new[:] = -1
            new[: self.capacity] = old
            setattr(self, name, new)
        self.capacity = newcap

    def enqueue(self, origin, dest, edge, has_edge, pay, seq, deliver_t,
                kind=KIND_DATA):
        k = origin.shape[0]
        if k == 0:
            return
        free = np.nonzero(self.deliver_t < 0)[0]
        if free.size < k:
            self._grow(k - free.size)
            free = np.nonzero(self.deliver_t < 0)[0]
        sl = free[:k]
        self.origin[sl] = origin
        self.dest[sl] = dest
        self.edge[sl] = edge
        self.has_edge[sl] = has_edge
        self.pay[sl] = pay
        self.seq[sl] = seq
        self.deliver_t[sl] = deliver_t
        self.kind[sl] = kind
        self.enqueued += k

    def due(self, t: int) -> np.ndarray:
        return np.nonzero(self.deliver_t == t)[0]

    def release(self, slots: np.ndarray, lost: bool = False):
        """Free `slots`; a lost release charges the fault ledger instead
        of the retired one (injected drop / crashed destination)."""
        n = int(np.asarray(slots).size)
        self.deliver_t[slots] = -1
        if lost:
            self.lost += n
        else:
            self.retired += n

    @property
    def in_flight(self) -> int:
        return int((self.deliver_t >= 0).sum())


def random_delays(rng: np.random.Generator, k: int, t: int) -> np.ndarray:
    return t + rng.integers(MIN_DELAY, MAX_DELAY + 1, size=k)
