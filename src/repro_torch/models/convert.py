"""Parameter trees and decode caches between the reference (JAX, numpy
leaves) and the port.

The reference stacks each segment's periods on a leading axis (one
``lax.scan`` per segment); the port keeps one tensor per period. Both
store projection weights as (in, out), so a leaf's values carry over
as they are, a MoE block's expert stacks (E, d, ff) / (E, ff, d) a
period too. Each leaf keeps its dtype: bfloat16 leaves (numpy's
``ml_dtypes.bfloat16``) cross bit for bit, and the float32 leaves stay
float32 in a bfloat16 model: the MoE's ``router_bias``, the mLSTM's
``b_if``, the sLSTM's ``b_gates``, and every xLSTM state in a decode
cache (an mLSTM's ``C`` / ``n`` / ``m``, an sLSTM's ``c`` / ``n`` /
``h`` / ``m``). An FFN-less block ('none') has no ``norm2`` / ``ffn``
on either side.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map


def _to_torch(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True).contiguous()
    a = np.array(a)  # a writable copy that the tensor may share
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _segments_from_jax(segs, layout, conv):
    """Each segment's stacked leaves (a leading period axis) as a list
    over its periods of a tuple of block trees; `layout` is the config's
    ``segments()`` or ``enc_segments()``."""
    host = lambda a: a if isinstance(a, torch.Tensor) else np.asarray(a)
    return [[tuple(tree_map(lambda a, i=i: conv(host(a)[i]), seg[j])
                   for j in range(len(pat)))
             for i in range(n)]
            for seg, (pat, n) in zip(segs, layout)]


def _segments_to_numpy(segs, layout):
    """The inverse: periods stacked on a leading axis, as numpy."""
    return [tuple(tree_map(lambda *ts: np.stack([_to_numpy(t) for t in ts]),
                           *[period[j] for period in seg])
                  for j in range(len(pat)))
            for seg, (pat, _) in zip(segs, layout)]


# the optional top-level leaves: an untied head, the encoder's final norm,
# the frontend's projection (the encoder's segments are laid out apart)
_EXTRA = ("lm_head", "enc_final_norm", "frontend_proj")


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cpu") -> Dict[str, Any]:
    """The port's parameters from the reference's tree (leaves as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``, or CPU tensors;
    a block's leaves may be dicts or, as read from a checkpoint, lists).
    Every leaf carries over, LayerNorm's bias ``b``, MLA's ``q_norm`` /
    ``kv_norm`` and the MoE's ``router``, ``router_bias``, expert
    stacks, ``shared`` expert and Arctic's ``ffn_dense`` among them, and
    so do an untied ``lm_head``, the encoder's ``enc_segments`` and
    ``enc_final_norm`` and a ``frontend_proj``."""
    conv = lambda a: _to_torch(
        a if isinstance(a, torch.Tensor) else np.asarray(a), device)
    out = {"embed": conv(tree["embed"]),
           "final_norm": tree_map(conv, tree["final_norm"]),
           "segments": _segments_from_jax(tree["segments"], cfg.segments(),
                                          conv)}
    if "enc_segments" in tree:
        out["enc_segments"] = _segments_from_jax(
            tree["enc_segments"], cfg.enc_segments(), conv)
    out.update({k: tree_map(conv, tree[k]) for k in _EXTRA if k in tree})
    return out


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """The reference's layout (periods stacked on a leading axis) as numpy
    arrays; bfloat16 leaves are widened to float32."""
    out = {"embed": _to_numpy(params["embed"]),
           "final_norm": tree_map(_to_numpy, params["final_norm"]),
           "segments": _segments_to_numpy(params["segments"],
                                          cfg.segments())}
    if "enc_segments" in params:
        out["enc_segments"] = _segments_to_numpy(params["enc_segments"],
                                                 cfg.enc_segments())
    out.update({k: tree_map(_to_numpy, params[k]) for k in _EXTRA
                if k in params})
    return out


def cache_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                   device="cpu") -> Dict[str, Any]:
    """The port's decode cache from the reference's (``{"pos": int32
    scalar, "segments": each period stacked on a leading axis}``, leaves
    as numpy arrays; a cross-attention block's ``xk`` / ``xv``, an
    MLA block's ``ckv`` / ``krope`` and an xLSTM block's float32 state
    too)."""
    conv = lambda a: _to_torch(np.asarray(a), device)
    return {"pos": conv(np.asarray(tree["pos"], np.int32)),
            "segments": _segments_from_jax(tree["segments"], cfg.segments(),
                                           conv)}


def cache_to_numpy(cache: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The port's decode cache in the reference's layout as numpy arrays
    ("pos" an int32 scalar); bfloat16 leaves are widened to float32."""
    return {"pos": np.int32(cache["pos"].item()),
            "segments": _segments_to_numpy(cache["segments"],
                                           cfg.segments())}


def _nest(pairs) -> Dict[str, Any]:
    """Leaves named by their ``/``-joined tree paths as a nested dict (a
    sequence's indices become its dict keys, "0", "1", ...)."""
    root: Dict[str, Any] = {}
    for name, leaf in pairs:
        *path, last = name.split("/")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return root


def _seq(node):
    """A nested dict whose keys are all sequence indices as a list."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_seq(node[str(i)]) for i in range(len(node))]
        return {k: _seq(v) for k, v in node.items()}
    return node


def train_state_from_checkpoint(directory: str, step: int, cfg: ModelConfig,
                                device="cpu"):
    """The port's (params, AdamW state, extra) from checkpoint `step` in
    `directory` that the reference's `CheckpointManager` wrote for
    ``{"params": params, "opt": opt_state}`` (its `run_plain`). The
    parameters (and m and v, float32) are re-laid from the reference's
    stacked periods; the step count becomes the port's host int; `extra`
    holds the data pipeline's ``state_dict`` under "data"."""
    from repro_torch.ckpt.checkpoint import load_leaves, leaf_tensor

    got, extra = load_leaves(directory, step)
    tree = _seq(_nest((m["name"], leaf_tensor(m, a)) for m, a in got))
    conv = lambda sub: params_from_jax(sub, cfg, device)
    opt = tree["opt"]
    return (conv(tree["params"]),
            {"m": conv(opt["m"]), "v": conv(opt["v"]),
             "count": int(opt["count"].item())},
            extra)

