"""The port's cycle engines (single device; majority, mean and L2
problems; Alg. 2 churn; the fault plane).

    from repro_torch.core.dht import Ring
    from repro_torch.engine import FaultConfig, make_engine
    eng = make_engine("torch", ring, votes, seed=0)   # on the GPU
    res = eng.run_until_converged(truth=1)
    eng.join(addr, vote=1); eng.leave(0)
    armed = make_engine("torch", ring, votes,
                        faults=FaultConfig(suspect_after=25, evict_after=150))
    armed.crash(3); armed.step(200)          # detected and evicted
    oracle = make_engine("numpy", ring, votes, seed=0)  # host numpy
    sweep = make_engine("torch", rings, votes_Bn, seed=0, batch=B)
    results = sweep.run_until_converged(truths)   # B EngineResults
    big = make_engine("torch", ring, votes, mesh=group)  # on every rank

`make_engine("torch", ...)` builds a `TorchEngine` (engine.torch_backend)
on CUDA unless ``device`` names another device; it raises when CUDA is
absent rather than falling back to the CPU. `make_engine("numpy", ...)`
builds the host oracle `NumpyEngine` (engine.numpy_backend), which has no
device. ``batch=B`` builds B independent trials (engine.batched): one
engine on the device whose wheel kernels launch once a cycle for all B,
or B host oracles. ``mesh=`` (a `torch.distributed` process group, True
for the default group, or its size) builds the sharded engine
(engine.sharded), one rank a process, bit-identical to `TorchEngine`.
"""
from __future__ import annotations

import numpy as np

from .base import (EngineResult, FaultConfig, MajorityEngine,
                   coalesced_update)
from .problems import (MAJORITY, PROBLEMS, L2Thresh, Majority, MeanMonitor,
                       ThresholdProblem, get_problem)

BACKENDS = ("torch", "numpy")


def make_engine(backend: str, ring, votes: np.ndarray, seed=0, device=None,
                batch: int = 0, mesh=None, **kwargs):
    """Construct the port's engine over `ring` with per-peer `votes`.

    `backend` is ``"torch"`` or ``"numpy"``. For torch, ``device=None``
    means CUDA, and the keyword arguments are `TorchEngine`'s:
    ``capacity_per_peer`` (default 6, as the reference), ``work_budget``,
    ``pad_to``, ``problem`` (an instance, or "majority" /
    "mean" / "l2"; `votes` is then the raw data the problem quantizes,
    and the wheel row width is P + 6), ``wheel_kernels`` ("auto": every
    CUDA kernel; "none": their plain versions; or a subset of
    `kernels.wheel.WHEEL_KERNELS`) and ``faults`` (a `FaultConfig` arms
    the fault plane). The numpy engine takes ``problem`` and ``faults``;
    ``device`` means nothing to it.

    With ``batch=B`` (B > 0), `votes` is (B, n) (or (B, n, D)), `ring` a
    single Ring or a list of B rings of equal (n, d), `seed` a scalar
    (per-trial seeds are seed + i) or a (B,) array, and the result runs B
    independent trials (`engine.batched`); ``faults=`` does not compose
    with it, as in the reference.

    With ``mesh=`` (torch only: a `torch.distributed` `ProcessGroup`,
    True for the default group, or an int equal to its size) the engine
    is `engine.sharded.ShardedTorchEngine`: every rank of the group
    builds it with the same arguments and holds its block of the peer
    planes and wheel lanes. ``device=None`` then means ``cuda:<rank>``
    when the node has a card for each rank, else the current CUDA
    device; the group's backend carries the collectives.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown engine backend {backend!r}; want one of {BACKENDS}")
    if mesh is not None:
        if backend != "torch":
            raise ValueError("mesh= sharding needs backend='torch'")
        if batch:
            raise NotImplementedError(
                "batch= and mesh= do not compose (trials of the sharded "
                "engine are later work, as in the reference)")
        from .sharded import ShardedTorchEngine, as_engine_group

        group = as_engine_group(mesh)
        if device is None:
            device = _rank_device(group)
        return ShardedTorchEngine(ring, votes, seed=seed, mesh=group,
                                  device=device, **kwargs)
    if batch:
        if kwargs.get("faults") is not None:
            raise NotImplementedError(
                "batch= and faults= do not compose (the failure detector's "
                "eviction sweep is a host event path per trial)")
        from . import batched

        if backend == "numpy":
            return batched.BatchedNumpyEngine(ring, votes, seed=seed, **kwargs)
        return batched.BatchedTorchEngine(ring, votes, seed=seed,
                                          device=device, **kwargs)
    if backend == "numpy":
        from .numpy_backend import NumpyEngine

        return NumpyEngine(ring, votes, seed=seed, **kwargs)
    from .torch_backend import TorchEngine

    return TorchEngine(ring, votes, seed=seed, device=device, **kwargs)


def _rank_device(group):
    """``cuda:<local rank>`` when the node has a card for each rank of
    `group`, else the current CUDA device; raises without CUDA, as every
    entry point of the port."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    resolve_device(None)
    if torch.cuda.device_count() >= dist.get_world_size(group):
        rank = dist.get_rank(group)
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return torch.device("cuda", torch.cuda.current_device())


def __getattr__(name):
    # the engine module imports the kernels, whose plain versions import
    # this package's protocol: load it on first use, not at import
    if name in ("DeviceState", "TorchEngine"):
        from . import torch_backend

        return getattr(torch_backend, name)
    if name == "NumpyEngine":
        from .numpy_backend import NumpyEngine

        return NumpyEngine
    if name in ("BatchedTorchEngine", "BatchedNumpyEngine"):
        from . import batched

        return getattr(batched, name)
    if name == "ShardedTorchEngine":
        from .sharded import ShardedTorchEngine

        return ShardedTorchEngine
    raise AttributeError(name)


__all__ = ["BACKENDS", "BatchedNumpyEngine", "BatchedTorchEngine",
           "DeviceState", "EngineResult", "FaultConfig",
           "L2Thresh", "MAJORITY", "Majority", "MajorityEngine",
           "MeanMonitor", "NumpyEngine", "PROBLEMS", "ShardedTorchEngine",
           "ThresholdProblem", "TorchEngine", "coalesced_update",
           "get_problem", "make_engine"]
