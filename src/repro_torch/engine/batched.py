"""Batched trials: B independent threshold runs as one engine.

The counterpart of `repro.engine.batched`. The paper's headline result
(§5) is a sweep — many independent trials run to convergence — and the
reference runs it as one vmapped device program. `torch.vmap` cannot
carry the port's data-dependent cycle, so `BatchedTorchEngine` keeps an
explicit trial axis instead (`engine.torch_backend`, ``_trials=``): the
trials are folded into the peer, link and lane axes the cycle already
has, so a cycle of all B trials is one pass of the engine's program and
each wheel kernel launches once a cycle whatever B is.

  * every trial carries its own ring addresses, data, seed-derived delay
    streams, cycle time and counters;
  * `run_until_converged` checks every trial before each cycle (one host
    read of B flags); a converged trial is frozen bit for bit while the
    rest step, as the reference's vmapped ``while_loop`` leaves it, and
    the chunk accounting is the reference's (``remaining -= max(used)``),
    so per-trial cycles and messages equal B serial runs;
  * rings must share (n, d); the padded tables are sized once for all.

`BatchedNumpyEngine` wraps B of the port's `NumpyEngine`s behind the same
API: the serial ground truth.

    eng = make_engine("torch", rings, votes_Bn, seed=0, batch=B)
    res = eng.run_until_converged(truths)      # list of B EngineResults
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from repro_torch.core.dht import Ring
from repro_torch.engine.base import EngineResult
from repro_torch.engine.problems import get_problem


def _as_rings(ring: Union[Ring, Sequence[Ring]], batch: int) -> List[Ring]:
    rings = [ring] * batch if isinstance(ring, Ring) else list(ring)
    if len(rings) != batch:
        raise ValueError(f"got {len(rings)} rings for batch={batch}")
    n, d = rings[0].n, rings[0].d
    for r in rings[1:]:
        if (r.n, r.d) != (n, d):
            raise ValueError("batched trials need rings of equal (n, d); "
                             f"got {(r.n, r.d)} vs {(n, d)}")
    return rings


def _as_seeds(seed, batch: int) -> List[int]:
    if np.isscalar(seed):
        return [int(seed) + i for i in range(batch)]
    seeds = [int(s) for s in np.asarray(seed).reshape(-1)]
    if len(seeds) != batch:
        raise ValueError(f"got {len(seeds)} seeds for batch={batch}")
    return seeds


def _batched_data(problem, votes) -> np.ndarray:
    votes = np.asarray(votes)
    want = 2 if problem.data_width == 1 else 3
    if votes.ndim != want:
        raise ValueError(
            f"batched {problem.name} data must be (B, n"
            f"{', D' if want == 3 else ''}), got {votes.shape}")
    return votes


class BatchedTorchEngine:
    """B trials on one device behind one API (leading axis = trial)."""

    backend = "torch"

    def __init__(self, ring: Union[Ring, Sequence[Ring]], votes: np.ndarray,
                 seed=0, device="cuda", **kwargs):
        from repro_torch.engine.torch_backend import CHUNK, TorchEngine

        self.problem = get_problem(kwargs.pop("problem", None))
        votes = _batched_data(self.problem, votes)
        self.batch = int(votes.shape[0])
        self.rings = _as_rings(ring, self.batch)
        seeds = _as_seeds(seed, self.batch)
        self.chunk = CHUNK
        self._eng = TorchEngine(
            self.rings[0], None, problem=self.problem, device=device,
            _trials=list(zip(self.rings, votes, seeds)), **kwargs)
        self.n, self.pad = self._eng.n, self._eng.pad
        self.device = self._eng.device

    # -- per-trial views -----------------------------------------------------

    def _per_trial(self, a: torch.Tensor) -> torch.Tensor:
        return a.view(self.batch, -1, *a.shape[1:])

    def _lane_sum(self, name: str) -> np.ndarray:
        # counters are per lane; the trial-level figure is the lane sum
        a = getattr(self._eng._st, name)
        return self._per_trial(a).sum(1).cpu().numpy().astype(np.int64)

    @property
    def t(self) -> np.ndarray:
        return self._eng._tb.copy()

    @property
    def messages_sent(self) -> np.ndarray:
        return self._lane_sum("messages_sent")

    @property
    def dropped(self) -> np.ndarray:
        return self._lane_sum("dropped")

    @property
    def deferred(self) -> np.ndarray:
        return self._lane_sum("deferred")

    def outputs(self) -> np.ndarray:
        """(B, n) current 0/1 outputs, all trials."""
        from repro_torch.engine.torch_backend import knowledge_outputs

        e = self._eng
        out = knowledge_outputs(self.problem, e._st.inbox, e._st.x, e.rows)
        return self._per_trial(out)[:, : self.n].cpu().numpy().astype(
            np.int64)

    def data(self) -> np.ndarray:
        """(B, n, D) quantized per-peer data planes, all trials."""
        x = self._per_trial(self._eng._st.x)[:, : self.n]
        return x.cpu().numpy().astype(np.int64)

    def votes(self) -> np.ndarray:
        x = self.data()
        return x[:, :, 0] if self.problem.data_width == 1 else x

    def state(self, b: int):
        """Trial `b`'s `DeviceState` (views into the batched state)."""
        from repro_torch.engine.torch_backend import trial_state

        return trial_state(self._eng._st, b, self.batch)

    def check_conservation(self) -> List[dict]:
        """Each trial's wheel conservation figures (see
        `TorchEngine.check_conservation`); raises AssertionError on a
        violation."""
        st, out = self._eng._st, []
        live = (self._per_trial(st.wcnt).sum((1, 2))
                + self._per_trial(st.acnt).sum((1, 2))).cpu().numpy()
        enq, ret, dro = (self._lane_sum(k) for k in ("enq", "ret", "dropped"))
        for b in range(self.batch):
            if enq[b] != ret[b] + live[b] + dro[b]:
                raise AssertionError(
                    f"trial {b}: wheel conservation violated: enqueued="
                    f"{enq[b]} != retired={ret[b]} + live={live[b]} + "
                    f"dropped={dro[b]}")
            out.append({"enqueued": int(enq[b]), "retired": int(ret[b]),
                        "live": int(live[b]), "dropped": int(dro[b])})
        return out

    # -- events and stepping -------------------------------------------------

    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray) -> None:
        """Data-change upcall, all trials at once: `idx` is (B, k),
        `new_votes` (B, k) scalar data or (B, k, D) vectors in RAW units
        (quantized through the problem); pad ragged trials with idx = -1
        (dropped; their values must still pass the problem's validation).
        Every trial reacts, as the reference's vmapped react."""
        e = self._eng
        idx = np.asarray(idx)
        nd = np.stack([self.problem.init_state(r)
                       for r in np.asarray(new_votes)]).astype(np.int32)
        keep = idx >= 0
        if (idx >= self.n).any():
            raise IndexError(f"peer index out of range [0, {self.n})")
        rows = (idx + self.pad * np.arange(self.batch)[:, None])[keep]
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        e._st.x[rows_t] = torch.from_numpy(nd[keep]).to(self.device)
        touched = torch.zeros(e.rows, dtype=torch.bool, device=self.device)
        touched[rows_t] = True
        e._react(touched)

    def step(self, cycles: int = 1) -> None:
        """Advance every trial by `cycles` cycles."""
        for _ in range(int(cycles)):
            self._eng._cycle()

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_until_converged(self, truth, max_cycles: int = 200_000,
                            stable_for: int = 1) -> List[EngineResult]:
        """Run every trial to convergence against its own `truth` ((B,)
        or scalar). Each cycle checks every trial first (one host read);
        a trial with `stable_for` consecutive true checks is done and
        frozen for the rest of the chunk, the others step. Chunks of at
        most `chunk` checks, as the reference's dispatches: a done trial
        re-checks once at each chunk start. Returns one `EngineResult`
        per trial."""
        B, e = self.batch, self._eng
        truths = torch.from_numpy(np.broadcast_to(
            np.asarray(truth), (B,)).astype(np.int32)).to(self.device)
        start_msgs = self.messages_sent
        stable = np.zeros(B, np.int64)
        remaining = int(max_cycles)
        done = np.zeros(B, bool)
        while remaining > 0 and not done.all():
            k = min(remaining, self.chunk)
            done = np.zeros(B, bool)
            used = np.zeros(B, np.int64)
            for _ in range(k):
                run = ~done
                conv = e._outputs_match(truths).cpu().numpy()
                stable = np.where(run, np.where(conv, stable + 1, 0), stable)
                done = done | (run & (stable >= stable_for))
                used += run
                if done.all():
                    break
                e._cycle(active=~done)
            remaining -= max(int(used.max()), 1)
        t, msgs, drops = self.t, self.messages_sent, self.dropped
        return [
            {"cycles": int(t[b]), "messages": int(msgs[b] - start_msgs[b]),
             "converged": 1.0 if done[b] else 0.0,
             "invalid": float(drops[b] > 0)}
            for b in range(B)
        ]


class BatchedNumpyEngine:
    """B serial host engines behind the batched API (the ground truth of
    the batched-vs-serial parity tests; no device)."""

    backend = "numpy"

    def __init__(self, ring: Union[Ring, Sequence[Ring]], votes: np.ndarray,
                 seed=0, **kwargs):
        from repro_torch.engine.numpy_backend import NumpyEngine

        self.problem = get_problem(kwargs.pop("problem", None))
        kwargs["problem"] = self.problem
        votes = _batched_data(self.problem, votes)
        self.batch = int(votes.shape[0])
        rings = _as_rings(ring, self.batch)
        seeds = _as_seeds(seed, self.batch)
        self.engines = [NumpyEngine(r, v, seed=s, **kwargs)
                        for r, v, s in zip(rings, votes, seeds)]
        self.n = rings[0].n

    @property
    def t(self) -> np.ndarray:
        return np.asarray([e.t for e in self.engines])

    @property
    def messages_sent(self) -> np.ndarray:
        return np.asarray([e.messages_sent for e in self.engines])

    @property
    def dropped(self) -> np.ndarray:
        return np.zeros(self.batch, np.int64)

    def outputs(self) -> np.ndarray:
        return np.stack([e.outputs() for e in self.engines])

    def votes(self) -> np.ndarray:
        return np.stack([e.votes() for e in self.engines])

    def data(self) -> np.ndarray:
        return np.stack([e.data() for e in self.engines])

    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray) -> None:
        idx = np.asarray(idx)
        new_votes = np.asarray(new_votes)
        for b, e in enumerate(self.engines):
            keep = idx[b] >= 0
            if keep.any():
                e.set_votes(idx[b][keep], new_votes[b][keep])

    def step(self, cycles: int = 1) -> None:
        for e in self.engines:
            e.step(cycles)

    def block_until_ready(self) -> None:
        pass

    def run_until_converged(self, truth, max_cycles: int = 200_000,
                            stable_for: int = 1) -> List[EngineResult]:
        truths = np.broadcast_to(np.asarray(truth), (self.batch,))
        return [e.run_until_converged(int(truths[b]), max_cycles=max_cycles,
                                      stable_for=stable_for)
                for b, e in enumerate(self.engines)]
