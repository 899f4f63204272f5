"""Deterministic synthetic token pipeline — sharded, checkpointable.

A verbatim copy of `repro.data.pipeline` (numpy only): for the same
seed, step and shard it gives the reference's batches bit for bit.

Real deployments plug a tokenized corpus in here; the framework contract is
only the iterator protocol below. The synthetic stream is a stateless
function of (seed, step, shard), so:
  * restart-from-checkpoint reproduces the exact batch sequence (the
    checkpoint stores just the step counter);
  * each data shard (host) generates only its slice — no cross-host I/O;
  * different seeds give independent streams for eval.

Tokens follow a Zipfian marginal with short-range Markov structure so that
losses are non-degenerate (pure uniform tokens make every model converge to
the same trivial loss, hiding training bugs).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


@dataclasses.dataclass
class DataState:
    step: int = 0


class SyntheticLM:
    """Deterministic synthetic LM batches: (tokens, targets) int32."""

    def __init__(self, cfg: DataConfig, state: Optional[DataState] = None):
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.state = state or DataState()
        v = cfg.vocab_size
        # fixed Zipf marginal + a seeded permutation as Markov successor map
        ranks = np.arange(1, v + 1)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        self._succ = rng.permutation(v)

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_shards

    def _rng_for(self, step: int) -> np.random.Generator:
        c = self.cfg
        return np.random.default_rng(
            (c.seed * 1_000_003 + step) * 65_537 + c.shard
        )

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        rng = self._rng_for(self.state.step)
        b, s = self.local_batch, c.seq_len
        base = rng.choice(c.vocab_size, size=(b, s), p=self._probs)
        # Markov smoothing: with p=0.5 the next token is succ[prev]
        follow = rng.random((b, s)) < 0.5
        toks = base.copy()
        toks[:, 1:] = np.where(follow[:, 1:], self._succ[toks[:, :-1]], base[:, 1:])
        tokens = toks.astype(np.int32)
        targets = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1
        )
        self.state.step += 1
        return tokens, targets

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- checkpoint protocol -------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.state.step}

    def load_state_dict(self, d: dict):
        self.state.step = int(d["step"])
