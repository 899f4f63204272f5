"""AdamW with global-norm clipping (the reference's `repro.optim.adamw`).

State mirrors the parameter tree with float32 m and v, plus a step
count (a host integer here; the reference keeps a device int32). The
update runs leaf by leaf and IN PLACE on the parameters and on m and v
(the reference returns new trees): the largest leaf, RecurrentGemma's
1.05 B-element embedding, then needs only a few float32 temporaries of
its size at a time.

Under the sharding plan (DTensor leaves, m and v placed by
`distributed.sharding.opt_state_specs`, ZeRO-1) each gradient, a
partial sum over the data axes, is reduce-scattered to m's placement
first; the global norm is taken over those shards, the update runs on
each rank's shard of m, v and the parameter, and the updated shard is
all-gathered back to the parameter's placement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4  # peak; multiplied by the schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def init_state(params) -> Dict[str, Any]:
    zeros = lambda t: torch.zeros(t.shape, dtype=F32, device=t.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": 0}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@torch.no_grad()
def apply_update(params, grads, state, cfg: AdamWConfig,
                 schedule_scale: float
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics {"grad_norm": 0-d device tensor, "lr": float}."""
    count = state["count"] + 1
    # a DTensor gradient to its optimizer state's placement (ZeRO-1)
    grads = [g.redistribute(m.device_mesh, m.placements)
             if isinstance(g, DTensor) else g
             for g, m in zip(leaves(grads), leaves(state["m"]))]
    gnorm = global_norm(grads)
    if isinstance(gnorm, DTensor):
        gnorm = gnorm.full_tensor()
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    cnt = torch.tensor(float(count), dtype=F32)
    b1c = float(1.0 - torch.tensor(cfg.b1, dtype=F32) ** cnt)
    b2c = float(1.0 - torch.tensor(cfg.b2, dtype=F32) ** cnt)
    lr = float(torch.tensor(cfg.lr, dtype=F32) * schedule_scale)
    for p, g, m, v in zip(leaves(params), grads, leaves(state["m"]),
                          leaves(state["v"])):
        gf = g.to(F32, copy=True) if scale is None else g.float() * scale
        m.mul_(cfg.b1).add_(gf * (1.0 - cfg.b1))
        v.mul_(cfg.b2).add_(gf.square_().mul_(1.0 - cfg.b2))
        del gf
        step = torch.div(m, b1c).div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
        if isinstance(p, DTensor):  # the rank's shard, then gathered back
            ps = p.redistribute(m.device_mesh, m.placements)
            step.add_(ps.float() * cfg.weight_decay)
            new = (ps.float() - step.mul_(lr)).to(p.dtype)
            p.copy_(new.redistribute(p.device_mesh, p.placements))
        else:
            step.add_(p.float() * cfg.weight_decay)
            p.copy_(p.float() - step.mul_(lr))
        del step
    return params, {"m": state["m"], "v": state["v"], "count": count}, {
        "grad_norm": gnorm, "lr": lr}
