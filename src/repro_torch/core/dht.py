"""Chord-style ring membership snapshot (paper §2, §4.1), host numpy.

Copied from `repro.core.dht.Ring`: a sorted ring of distinct d-bit peer
addresses, peer i owning the segment ``(addrs[i-1], addrs[i]]`` (cyclic;
the minimum-address peer owns the wrapped segment containing 0 and is the
tree root), with its finger tables at ``a_i + 2^j`` (Chord) or
``a_i ± 2^j`` (Symmetric Chord) and greedy lookup with hop counting,
vectorized over many queries (the stretch of the binary routing tree,
Fig. 4.1b; the fingers are the gossip baseline's links, `core.limosense`).
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


def finger_tables(ring: Ring, symmetric: bool) -> np.ndarray:
    """(n, nf) peer indices; fingers at a_i + 2^j (and - 2^j if symmetric).

    Includes the successor (j=0 clockwise) so greedy routing can always
    fall back to +1 steps.
    """
    n, d = ring.n, ring.d
    js = np.arange(d, dtype=np.uint64)
    step = (np.uint64(1) << js).astype(ring.addrs.dtype)
    mask = ring.addrs.dtype.type(A.mask_of(d))
    targets = (ring.addrs[:, None] + step[None, :]) & mask
    if symmetric:
        targets_ccw = (ring.addrs[:, None] - step[None, :]) & mask
        targets = np.concatenate([targets, targets_ccw], axis=1)
    return ring.owner(targets.ravel()).reshape(n, -1)


def lookup_hops(
    ring: Ring,
    fingers: np.ndarray,
    src: np.ndarray,
    target_addr: np.ndarray,
    symmetric: bool,
    max_hops: int = 512,
) -> np.ndarray:
    """Greedy DHT lookup hop counts, vectorized over queries.

    Chord: classic closest-preceding-finger toward the clockwise distance.
    Symmetric Chord: closest finger by *ring* distance (either direction)
    with strict-improvement fallback to successor steps.
    """
    mask = ring.addrs.dtype.type(A.mask_of(ring.d))
    owner = ring.owner(target_addr)
    cur = src.astype(np.int64).copy()
    hops = np.zeros(src.shape, dtype=np.int64)
    t = target_addr
    for _ in range(max_hops):
        live = cur != owner
        if not live.any():
            break
        li = np.nonzero(live)[0]
        f = fingers[cur[li]]  # (q, nf) peer indices
        fa = ring.addrs[f]  # (q, nf) finger addresses
        a_cur = ring.addrs[cur[li]][:, None]
        tt = t[li][:, None]
        if symmetric:
            dcw = (tt - fa) & mask
            dccw = (fa - tt) & mask
            dist = np.minimum(dcw, dccw)
            cur_dist = np.minimum((tt[:, 0] - a_cur[:, 0]) & mask,
                                  (a_cur[:, 0] - tt[:, 0]) & mask)
            dist = np.where(fa == a_cur, mask, dist)  # exclude self
            best = np.argmin(dist, axis=1)
            bd = dist[np.arange(dist.shape[0]), best]
            nxt = f[np.arange(f.shape[0]), best]
            # no strict improvement -> step to successor (guaranteed progress)
            stuck = bd >= cur_dist
            nxt = np.where(stuck, (cur[li] + 1) % ring.n, nxt)
        else:
            # finger must lie in (cur, target] clockwise; minimize remaining cw dist
            prog = (fa - a_cur) & mask
            span = (tt - a_cur) & mask
            valid = (prog > 0) & (prog <= span)
            dcw = (tt - fa) & mask
            dcw = np.where(valid, dcw, mask)
            best = np.argmin(dcw, axis=1)
            has = valid[np.arange(valid.shape[0]), best]
            nxt = np.where(has, f[np.arange(f.shape[0]), best], (cur[li] + 1) % ring.n)
        cur[li] = nxt
        hops[li] += 1
    return hops
