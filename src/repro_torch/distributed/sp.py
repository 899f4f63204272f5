"""Sequence parallelism (the port's `repro.distributed.sp`): between
blocks the residual stream is sharded over the tensor-parallel axis
along the sequence, so norms and residual adds run on 1/tp of it, and
the TP all-reduce becomes a reduce-scatter and a later all-gather (half
the wire bytes; Korthikanti et al., 2022).

The reference asks GSPMD for it with a sharding constraint; here a
DTensor activation is redistributed to that layout and DTensor inserts
the collectives. Enabled per config (``ModelConfig.seq_shard``); the
mesh axes are module context, as in the reference (configs stay
hashable). A plain tensor, or no axes set, passes through unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_CTX = {"batch_axes": None, "tp_axis": "model"}


def set_sp_axes(batch_axes: Optional[Tuple[str, ...]], tp_axis: str = "model"):
    _CTX["batch_axes"] = tuple(batch_axes) if batch_axes else None
    _CTX["tp_axis"] = tp_axis


def seq_constraint(x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) activations to (batch, TP, None): Shard(0) on the batch
    axes, Shard(1) on the TP axis, Replicate on any other."""
    ba = _CTX["batch_axes"]
    if ba is None or not isinstance(x, DTensor):
        return x
    if x.shape[1] % 16 and x.shape[1] % 2:  # oddly-shaped seq: skip
        return x
    names = x.device_mesh.mesh_dim_names
    want = [Shard(0) if n in ba else Shard(1) if n == _CTX["tp_axis"]
            else Replicate() for n in names]
    return x.redistribute(x.device_mesh, want)
