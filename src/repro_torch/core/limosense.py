"""LiMoSense gossip majority voting (paper §3.2) — failure-free variant.

Copied from `repro.core.limosense` for the port's host numpy layer: the
gossip baseline of the paper's headline comparison.

LiMoSense [9] is a push-sum style live-averaging gossip algorithm. As in the
paper we (a) pick destinations uniformly from the peer's finger table rather
than uniformly from all peers (a random finger walk reaches a uniformly
random peer in O(log N) messages on a DHT), and (b) quantize the output to
{0,1} against the 1/2 threshold.

State per peer: value mass s_i and weight w_i; estimate est_i = s_i / w_i.
  init            s_i = x_i, w_i = 1
  input change    s_i += x_new - x_old                (live adjustment)
  gossip send     transfer (s_i/2, w_i/2) to a uniformly-random finger
  receive (s, w)  s_i += s, w_i += w
  output          1 iff est_i >= 1/2

Every send is one network message (fingers are direct links — 1 hop),
the same unit the local algorithm is charged in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .dht import Ring, finger_tables
from .simulator import MIN_DELAY, MAX_DELAY


@dataclass
class GossipParams:
    send_prob: float = 1.0  # probability a peer gossips in a given cycle


class LiMoSenseSimulator:
    """Cycle-driven gossip simulator with in-flight (s, w) messages."""

    def __init__(
        self,
        ring: Ring,
        votes: np.ndarray,
        symmetric: bool = True,
        seed: int = 0,
        params: GossipParams = GossipParams(),
    ):
        self.ring = ring
        n = ring.n
        self.n = n
        self.fingers = finger_tables(ring, symmetric=symmetric)
        # distinct destinations only (the paper: "uniformly from among the
        # *different* destinations in the peer's finger table")
        self.rng = np.random.default_rng(seed)
        self.s = votes.astype(np.float64).copy()
        self.w = np.ones(n)
        self.x = votes.astype(np.float64).copy()
        self.params = params
        self.t = 0
        self.messages_sent = 0
        # in-flight messages: ring buffer by delivery cycle
        self.maxd = MAX_DELAY + 1
        self.buf_dst = [np.empty(0, np.int64) for _ in range(self.maxd)]
        self.buf_s = [np.empty(0) for _ in range(self.maxd)]
        self.buf_w = [np.empty(0) for _ in range(self.maxd)]

    def outputs(self) -> np.ndarray:
        return (self.s / self.w >= 0.5).astype(np.int64)

    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray):
        nv = new_votes.astype(np.float64)
        self.s[idx] += nv - self.x[idx]
        self.x[idx] = nv

    def step(self):
        slot = self.t % self.maxd
        # deliver
        dst, ms, mw = self.buf_dst[slot], self.buf_s[slot], self.buf_w[slot]
        if dst.size:
            np.add.at(self.s, dst, ms)
            np.add.at(self.w, dst, mw)
            self.buf_dst[slot] = np.empty(0, np.int64)
            self.buf_s[slot] = np.empty(0)
            self.buf_w[slot] = np.empty(0)
        # gossip
        p = self.params.send_prob
        senders = (
            np.nonzero(self.rng.random(self.n) < p)[0]
            if p < 1.0
            else np.arange(self.n)
        )
        if senders.size:
            f = self.fingers[senders]
            pick = self.rng.integers(0, f.shape[1], size=senders.size)
            dst = f[np.arange(senders.size), pick]
            # avoid self-sends (successor of own address can be self)
            ok = dst != senders
            senders, dst = senders[ok], dst[ok]
            half_s, half_w = self.s[senders] / 2, self.w[senders] / 2
            self.s[senders] -= half_s
            self.w[senders] -= half_w
            delay = self.rng.integers(MIN_DELAY, MAX_DELAY + 1, size=senders.size)
            for dd in np.unique(delay):
                sel = delay == dd
                j = (self.t + int(dd)) % self.maxd
                self.buf_dst[j] = np.concatenate([self.buf_dst[j], dst[sel]])
                self.buf_s[j] = np.concatenate([self.buf_s[j], half_s[sel]])
                self.buf_w[j] = np.concatenate([self.buf_w[j], half_w[sel]])
            self.messages_sent += senders.size
        self.t += 1

    def run_until_converged(self, truth: int, max_cycles: int = 20_000) -> Dict[str, float]:
        start = self.messages_sent
        for _ in range(max_cycles):
            if (self.outputs() == truth).all():
                return {"cycles": self.t, "messages": self.messages_sent - start,
                        "converged": 1.0}
            self.step()
        return {"cycles": self.t, "messages": self.messages_sent - start,
                "converged": 0.0}
