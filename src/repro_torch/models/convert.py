"""Parameter trees between the reference (JAX, numpy leaves) and the
port.

The reference stacks each segment's periods on a leading axis (one
``lax.scan`` per segment); the port keeps one tensor per period. Both
store projection weights as (in, out), so a leaf's values carry over
as they are. bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``) cross
bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy that the tensor may share
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cpu") -> Dict[str, Any]:
    """The port's parameters from the reference's tree (leaves as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``)."""
    conv = lambda a: _to_torch(np.asarray(a), device)
    segments = []
    for seg, (pat, n) in zip(tree["segments"], cfg.segments()):
        segments.append([
            tuple(tree_map(lambda a, i=i: conv(np.asarray(a)[i]), seg[j])
                  for j in range(len(pat)))
            for i in range(n)])
    return {"embed": conv(tree["embed"]),
            "final_norm": tree_map(conv, tree["final_norm"]),
            "segments": segments}


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """The reference's layout (periods stacked on a leading axis) as numpy
    arrays; bfloat16 leaves are widened to float32."""
    segments = []
    for seg, (pat, _) in zip(params["segments"], cfg.segments()):
        segments.append(tuple(
            tree_map(lambda *ts: np.stack([_to_numpy(t) for t in ts]),
                     *[period[j] for period in seg])
            for j in range(len(pat))))
    return {"embed": _to_numpy(params["embed"]),
            "final_norm": tree_map(_to_numpy, params["final_norm"]),
            "segments": segments}
