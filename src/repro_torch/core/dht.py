"""Chord-style ring membership snapshot (paper §2, §4.1), host numpy.

Copied from `repro.core.dht.Ring`: a sorted ring of distinct d-bit peer
addresses, peer i owning the segment ``(addrs[i-1], addrs[i]]`` (cyclic;
the minimum-address peer owns the wrapped segment containing 0 and is the
tree root). The finger-table lookup model is not part of the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from . import addressing as A


@dataclass(frozen=True)
class Ring:
    """A snapshot of the overlay membership."""

    addrs: np.ndarray  # sorted, distinct, unsigned
    d: int

    @classmethod
    def random(cls, n: int, d: int, seed: int = 0, dtype=np.uint64) -> "Ring":
        return cls(A.random_ring(n, d, seed, dtype=dtype), d)

    @property
    def n(self) -> int:
        return int(self.addrs.size)

    @property
    def prev(self) -> np.ndarray:
        return np.roll(self.addrs, 1)

    def positions(self) -> np.ndarray:
        return A.ring_positions(self.addrs, self.d)

    def owner(self, targets: np.ndarray) -> np.ndarray:
        """Peer index owning each target address (successor with wrap)."""
        idx = np.searchsorted(self.addrs, targets, side="left")
        return idx % self.n

    def join(self, addr: int) -> Tuple["Ring", int]:
        """Insert a peer; returns (new ring, index of the new peer)."""
        a = self.addrs.dtype.type(addr)
        if a in self.addrs:
            raise ValueError("address already occupied")
        new = np.sort(np.append(self.addrs, a))
        return Ring(new, self.d), int(np.searchsorted(new, a))

    def leave(self, idx: int) -> "Ring":
        return Ring(np.delete(self.addrs, idx), self.d)
