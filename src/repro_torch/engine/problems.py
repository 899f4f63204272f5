"""Threshold problems — the pluggable decision rule behind Alg. 3.

The counterpart of `repro.engine.problems` for this slice: the generic
safe-zone test (`ThresholdProblem`) and the paper's majority vote
(`Majority`). A problem supplies its data width D, the host-side
quantization `init_state`, the signed `margin` over a (..., P) payload
(P = D + 1) and the convergence predicate. Written against an explicit
array namespace `xp` (``torch`` on the engine path, ``numpy`` on the
host), as in the reference.

The mean-monitoring and L2 problems are ROADMAP item A4 ("Mean and L2
problems"); `get_problem` raises `NotImplementedError` for them.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np

Array = Any  # torch.Tensor | np.ndarray

NOT_PORTED = ("the mean and L2 threshold problems are not ported yet "
              "(ROADMAP.md, queue A: 'Mean and L2 problems')")


class ThresholdProblem:
    """Base class: the generic safe-zone test over a problem `margin`."""

    name = "threshold"
    data_width = 1  # D

    @property
    def payload_width(self) -> int:
        """P = D + 1: vector-sum columns plus the count column."""
        return self.data_width + 1

    def init_state(self, data: np.ndarray) -> np.ndarray:
        """Quantize raw per-peer data to the (n, D) int64 plane."""
        a = np.asarray(data)
        if not np.issubdtype(a.dtype, np.integer):
            raise TypeError(
                f"{self.name} expects integer data; override init_state "
                "to quantize floats")
        if a.ndim == 1:
            a = a[:, None]
        if a.ndim != 2 or a.shape[1] != self.data_width:
            raise ValueError(
                f"{self.name} data must be (n,) or (n, {self.data_width}), "
                f"got {a.shape}")
        return a.astype(np.int64)

    def margin(self, xp, pay: Array) -> Array:
        """Signed distance of payload ``pay[..., :D+1]`` from the
        threshold surface; output 1 iff margin(K) >= 0."""
        raise NotImplementedError

    def test(self, xp, agg: Array, k: Array) -> Tuple[Array, Array]:
        """Safe-zone test: (send (..., 3) bool — margins of A and K - A
        disagree; output (...,) bool — margin(K) >= 0)."""
        ta = self.margin(xp, agg)
        tka = self.margin(xp, k[..., None, :] - agg)
        send = ((ta >= 0) & (tka < 0)) | ((ta < 0) & (tka > 0))
        return send, self.margin(xp, k) >= 0

    def converged(self, xp, outputs: Array, truth: Array) -> Array:
        """Per-peer convergence predicate: the peer outputs the target."""
        return outputs == truth

    def global_output(self, data: np.ndarray) -> int:
        """Ground-truth decision from the quantized (n, D) data plane."""
        k = np.concatenate(
            [data.sum(0).astype(np.int64), [np.int64(data.shape[0])]])
        return int(self.margin(np, k) >= 0)

    def __repr__(self):
        return f"{type(self).__name__}()"


class Majority(ThresholdProblem):
    """The paper's Alg. 3: is the fraction of 1-votes >= 1/2?
    Payload = (ones, total); margin = 2*ones - total."""

    name = "majority"
    data_width = 1

    def init_state(self, data: np.ndarray) -> np.ndarray:
        a = super().init_state(data)
        if not np.isin(a, (0, 1)).all():
            raise ValueError("majority votes must be 0/1")
        return a

    def margin(self, xp, pay: Array) -> Array:
        return 2 * pay[..., 0] - pay[..., 1]


MAJORITY = Majority()  # the default problem (`get_problem(None)`)


def get_problem(spec) -> ThresholdProblem:
    """Resolve a problem from an instance, a name, or None (majority)."""
    if spec is None:
        return MAJORITY
    if isinstance(spec, ThresholdProblem):
        return spec
    if spec == "majority":
        return Majority()
    if spec in ("mean", "l2"):
        raise NotImplementedError(NOT_PORTED)
    raise ValueError(
        f"unknown threshold problem {spec!r}; want one of "
        "['l2', 'majority', 'mean']")
