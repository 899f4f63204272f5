"""Threshold problems — the pluggable decision rule behind Alg. 3.

The counterpart of `repro.engine.problems`: the generic safe-zone test
(`ThresholdProblem`), the paper's majority vote (`Majority`), mean
monitoring (`MeanMonitor`) and L2-norm thresholding (`L2Thresh`). A
problem supplies its data width D, the host-side quantization
`init_state` / `peer_data`, the signed `margin` over a (..., P) payload
(P = D + 1) and the convergence predicate.

`margin` and `test` take an array namespace `xp` as the reference's do,
and work on what they are given: torch tensors (the engine) or numpy
arrays (the host layer, `core.majority`). Quantization (`init_state`,
`peer_data`) and `global_output` are host numpy.

Exactness: integer margins wrap in int32 as the reference's device int32
does; `L2Thresh`'s float32 margins keep the reference's unrolled
accumulation order (see `L2Thresh._proj`), so every result is
bit-identical to the reference engine's.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

Array = Any  # torch.Tensor | np.ndarray


def _is_torch(a) -> bool:
    return isinstance(a, torch.Tensor)


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

    def peer_data(self, value) -> np.ndarray:
        """One joining peer's (D,) int64 data row (Alg. 2 `join`);
        scalars broadcast across the D components."""
        a = np.asarray(value)
        if a.ndim == 0:
            a = np.broadcast_to(a, (self.data_width,))
        return self.init_state(a[None, :])[0]

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


class MeanMonitor(ThresholdProblem):
    """Mean monitoring: is the network-wide mean of a scalar stream
    >= ``tau``? Raw floats are fixed-point quantized once on the host
    (``q = round(x * scale)``); margin = sum(q) - T * count with
    ``T = round(tau * scale)``, integer-exact while |sum(q)| and T * n
    fit int32."""

    name = "mean"
    data_width = 1

    def __init__(self, tau: float = 0.0, scale: int = 256):
        self.tau = float(tau)
        self.scale = int(scale)
        self.T = int(round(self.tau * self.scale))

    def init_state(self, data: np.ndarray) -> np.ndarray:
        a = np.asarray(data, np.float64)
        if a.ndim == 1:
            a = a[:, None]
        if a.ndim != 2 or a.shape[1] != 1:
            raise ValueError(f"mean data must be (n,) or (n, 1), got {a.shape}")
        return np.round(a * self.scale).astype(np.int64)

    def margin(self, xp, pay: Array) -> Array:
        return pay[..., 0] - self.T * pay[..., 1]

    def __repr__(self):
        return f"MeanMonitor(tau={self.tau}, scale={self.scale})"


class L2Thresh(ThresholdProblem):
    """L2-norm thresholding: is ||mean vector|| >= tau for D-dimensional
    per-peer data?

    The outside of the ball is covered by half-spaces tangent to the
    sphere at a fixed direction set U (``ndirs`` directions, frozen at
    construction): f_m(X) = <s, u_m> - T*c with T = tau * scale, and
    margin(X) = max_m f_m(X). `test` checks A and K - A against the
    convex region K occupies: the argmax half-space when K is outside
    (margin(K) >= 0), every half-space when K is inside.

    Margins are float32 with the reference's unrolled accumulation (no
    library reduction that could reassociate), so they are bit-identical
    to the reference's.
    """

    name = "l2"

    def __init__(self, tau: float = 1.0, dim: int = 2, scale: int = 256,
                 ndirs: int = 16):
        self.tau = float(tau)
        self.data_width = int(dim)
        self.scale = int(scale)
        self.Tf = np.float32(self.tau * self.scale)
        self.U = self._direction_cover(self.data_width, int(ndirs))

    @staticmethod
    def _direction_cover(dim: int, ndirs: int) -> np.ndarray:
        """(M, D) float32 unit directions. D=1: exact {+1, -1}; D=2:
        evenly spaced angles; D>=3: the +/- axes plus a seeded
        normalized-Gaussian fill (every instance with the same
        (dim, ndirs) shares the cover)."""
        if dim == 1:
            return np.asarray([[1.0], [-1.0]], np.float32)
        if dim == 2:
            ang = 2 * np.pi * np.arange(ndirs) / ndirs
            return np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
        axes = np.concatenate([np.eye(dim), -np.eye(dim)])
        extra = max(ndirs - 2 * dim, 0)
        g = np.random.default_rng(dim * 1000 + ndirs).normal(
            size=(extra, dim))
        g /= np.linalg.norm(g, axis=1, keepdims=True)
        return np.concatenate([axes, g]).astype(np.float32)

    def init_state(self, data: np.ndarray) -> np.ndarray:
        a = np.asarray(data, np.float64)
        if a.ndim != 2 or a.shape[1] != self.data_width:
            raise ValueError(
                f"l2 data must be (n, {self.data_width}), got {a.shape}")
        return np.round(a * self.scale).astype(np.int64)

    def _proj(self, pay: Array) -> Array:
        """(..., M) tangent-half-space margins f_m = <s, u_m> - T*c, in
        the reference's order: p0*u0, then + pj*uj, then - Tf*c."""
        if _is_torch(pay):
            U = torch.from_numpy(self.U).to(pay.device)
            f = lambda j: pay[..., j].to(torch.float32)[..., None]
            tf = float(self.Tf)
        else:
            U, tf = self.U, self.Tf
            f = lambda j: pay[..., j].astype(np.float32)[..., None]
        acc = f(0) * U[:, 0]
        for j in range(1, self.data_width):  # unrolled, fixed op order
            acc = acc + f(j) * U[:, j]
        return acc - tf * f(self.data_width)

    def margin(self, xp, pay: Array) -> Array:
        p = self._proj(pay)
        return p.amax(-1) if _is_torch(p) else p.max(-1)

    def test(self, xp, agg: Array, k: Array):
        """Region-wise safe-zone test: K outside -> the Alg. 3 comparison
        on the argmax half-space (the first maximum); K inside -> on
        every half-space (violation if any violates)."""
        pk = self._proj(k)                          # (..., M)
        m_star = pk.argmax(-1)                      # (...,)
        pa = self._proj(agg)                        # (..., 3, M)
        pka = self._proj(k[..., None, :] - agg)
        viol_m = ((pa >= 0) & (pka < 0)) | ((pa < 0) & (pka > 0))
        if _is_torch(pk):
            out = pk.amax(-1) >= 0
            sel = m_star[..., None, None].expand(*viol_m.shape[:-1], 1)
            viol_out = torch.take_along_dim(viol_m, sel, -1)[..., 0]
            return torch.where(out[..., None], viol_out, viol_m.any(-1)), out
        out = pk.max(-1) >= 0
        viol_out = np.take_along_axis(viol_m, m_star[..., None, None], -1)
        return np.where(out[..., None], viol_out[..., 0], viol_m.any(-1)), out

    def __repr__(self):
        return (f"L2Thresh(tau={self.tau}, dim={self.data_width}, "
                f"scale={self.scale}, ndirs={self.U.shape[0]})")


MAJORITY = Majority()  # the default problem (`get_problem(None)`)

PROBLEMS = {"majority": Majority, "mean": MeanMonitor, "l2": L2Thresh}


def get_problem(spec, **kwargs) -> ThresholdProblem:
    """Resolve a problem instance from an instance, a name, or None
    (majority)."""
    if spec is None:
        return MAJORITY
    if isinstance(spec, ThresholdProblem):
        return spec
    if spec in PROBLEMS:
        return PROBLEMS[spec](**kwargs)
    raise ValueError(
        f"unknown threshold problem {spec!r}; want one of {sorted(PROBLEMS)}")
