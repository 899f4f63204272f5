"""The port's cycle engine (single device; majority, mean and L2
problems; Alg. 2 churn).

    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine
    eng = make_engine("torch", ring, votes, seed=0)   # on the GPU
    res = eng.run_until_converged(truth=1)
    eng.join(addr, vote=1); eng.leave(0)

`make_engine("torch", ...)` builds a `TorchEngine` (engine.torch_backend)
on CUDA unless ``device`` names another device; it raises when CUDA is
absent rather than falling back to the CPU.
"""
from __future__ import annotations

import numpy as np

from .base import EngineResult, FaultConfig, coalesced_update
from .problems import (MAJORITY, PROBLEMS, L2Thresh, Majority, MeanMonitor,
                       ThresholdProblem, get_problem)

BACKENDS = ("torch",)


def make_engine(backend: str, ring, votes: np.ndarray, seed=0, device=None,
                **kwargs):
    """Construct the port's engine over `ring` with per-peer `votes`.

    `backend` must be ``"torch"``. ``device=None`` means CUDA. Keyword
    arguments are `TorchEngine`'s: ``capacity_per_peer`` (default 6, as
    the reference), ``work_budget``, ``pad_to``, ``problem`` (an instance,
    or "majority" / "mean" / "l2"; `votes` is then the raw data the
    problem quantizes, and the wheel row width is P + 6) and
    ``wheel_kernels`` ("auto": every CUDA kernel; "none": their plain
    versions; or a subset of `kernels.wheel.WHEEL_KERNELS`).
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown engine backend {backend!r}; want one of {BACKENDS}")
    from .torch_backend import TorchEngine

    return TorchEngine(ring, votes, seed=seed, device=device, **kwargs)


def __getattr__(name):
    # the engine module imports the kernels, whose plain versions import
    # this package's protocol: load it on first use, not at import
    if name in ("DeviceState", "TorchEngine"):
        from . import torch_backend

        return getattr(torch_backend, name)
    raise AttributeError(name)


__all__ = ["BACKENDS", "DeviceState", "EngineResult", "FaultConfig",
           "L2Thresh", "MAJORITY", "Majority", "MeanMonitor", "PROBLEMS",
           "ThresholdProblem", "TorchEngine", "coalesced_update",
           "get_problem", "make_engine"]
