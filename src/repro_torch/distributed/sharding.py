"""Partition rules (the port's `repro.distributed.sharding`): parameters,
inputs, decode caches and optimizer state -> `P` spec trees, and the
trees placed as DTensors on a `DeviceMesh` by those specs.

The rules are derived structurally from the same `BlockDef` pattern that
built the parameters (`models.model._init_block`), as the reference's.
Baseline layout (the reference's DESIGN.md §5):

  batch axes        ('pod', 'data'): data parallel
  'model' axis      tensor parallel: attention heads (as the flattened
                    hq * dh), FFN hidden, vocab (embed rows, lm_head
                    columns), MoE experts, RG-LRU width
  replicated        norms, biases, routers, MLA's low-rank 'a'
                    projections, the sLSTM (tiny, serial)
  optimizer m / v   also sharded over 'data' on the largest dimension
                    that divides (ZeRO-1)
  decode caches     batch over the data axes; KV heads over 'model' when
                    they divide, else the sequence; recurrent state width
                    over 'model'; cross-attention caches replicated

The port's parameters hold one tensor per period (`models.convert`),
where the reference stacks a segment's periods on a leading axis for its
scan; so the reference's `_stack` (a leading None on every leaf spec)
becomes one spec tree per period here, and a spec is the reference's
with its periods axis dropped.

`P` stands in for JAX's ``PartitionSpec``: an immutable tuple of axis
names (None, a name, or a tuple of names) with the reference's equality.
Mesh arguments are a `DeviceMesh` or a ``{axis: size}`` dict (the
shape dict the reference's tests pass as ``mesh.shape``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import BlockDef, ModelConfig, ShapeConfig
from repro_torch.tree import leaves

TP = "model"


def _axis(a):
    """One entry normalised as JAX does: a one-name tuple is the name,
    an empty one None."""
    if isinstance(a, (tuple, list)):
        a = tuple(a)
        return None if not a else a[0] if len(a) == 1 else a
    return a


class P(tuple):
    """A partition spec: entry i names the mesh axis (or axes) that
    dimension i is split over, None for none."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_axis(a) for a in axes))

    def __repr__(self):
        return "P" + super().__repr__()


def is_spec(x) -> bool:
    return isinstance(x, P)


def spec_map(fn, specs, *rest):
    """`fn` over the P leaves of `specs` and the same places in `rest`
    (trees of dicts, lists and tuples)."""
    if is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: spec_map(fn, specs[k], *(r[k] for r in rest))
                for k in specs}
    if isinstance(specs, (list, tuple)):
        return type(specs)(spec_map(fn, s, *(r[i] for r in rest))
                           for i, s in enumerate(specs))
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _norm_spec(kind: str):
    if kind == "layernorm":
        return {"w": P(), "b": P()}
    return {"w": P()}


def _attn_spec(cfg) -> Dict[str, Any]:
    s = {"wq": P(None, TP), "wk": P(None, TP), "wv": P(None, TP),
         "wo": P(TP, None)}
    if cfg.attn_bias:
        s.update(bq=P(TP), bk=P(TP), bv=P(TP), bo=P())
    if cfg.qk_norm:
        s.update(qnorm=_norm_spec("rmsnorm"), knorm=_norm_spec("rmsnorm"))
    return s


def _cross_spec(cfg) -> Dict[str, Any]:
    return {"wq": P(None, TP), "wk": P(None, TP), "wv": P(None, TP),
            "wo": P(TP, None),
            "qnorm": _norm_spec("rmsnorm"), "knorm": _norm_spec("rmsnorm"),
            "gate_attn": P()}


def _mla_spec(cfg) -> Dict[str, Any]:
    return {"wq_a": P(), "q_norm": _norm_spec("rmsnorm"), "wq_b": P(None, TP),
            "wkv_a": P(), "kv_norm": _norm_spec("rmsnorm"),
            "wkv_b": P(None, TP), "wo": P(TP, None)}


def _mlp_spec(gated: bool) -> Dict[str, Any]:
    s = {"w_up": P(None, TP), "w_down": P(TP, None)}
    if gated:
        s["w_gate"] = P(None, TP)
    return s


def _moe_spec(cfg) -> Dict[str, Any]:
    s = {"router": P(), "router_bias": P(),
         # experts sharded: expert parallelism over the TP axis
         "w_gate": P(TP, None, None), "w_up": P(TP, None, None),
         "w_down": P(TP, None, None)}
    if cfg.moe.n_shared:
        s["shared"] = _mlp_spec(True)
    return s


def _rglru_spec(cfg) -> Dict[str, Any]:
    return {"w_x": P(None, TP), "w_gate": P(None, TP),
            "conv_w": P(None, TP), "conv_b": P(TP),
            "rg_wa": P(TP, None, None), "rg_wx": P(TP, None, None),
            "log_lambda": P(TP), "w_out": P(TP, None)}


def _mlstm_spec(cfg) -> Dict[str, Any]:
    return {"w_up": P(None, TP), "w_gate": P(None, TP),
            "w_q": P(TP, None), "w_k": P(TP, None), "w_v": P(TP, None),
            "w_if": P(TP, None), "b_if": P(),
            "w_down": P(TP, None), "skip_norm": {"w": P(TP)}}


def _slstm_spec(cfg) -> Dict[str, Any]:
    # tiny and inherently serial: replicated
    return {"w_gates": P(), "r_gates": P(), "b_gates": P(), "w_out": P()}


def _block_spec(bd: BlockDef, cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": _norm_spec(cfg.norm)}
    if bd.mixer in ("attn", "swa", "bidir"):
        s["mixer"] = _attn_spec(cfg)
    elif bd.mixer == "mla":
        s["mixer"] = _mla_spec(cfg)
    elif bd.mixer == "xattn":
        s["mixer"] = _cross_spec(cfg)
    elif bd.mixer == "dec":
        s["mixer"] = _attn_spec(cfg)
        s["cross"] = _cross_spec(cfg)
        s["norm_cross"] = _norm_spec(cfg.norm)
    elif bd.mixer == "rglru":
        s["mixer"] = _rglru_spec(cfg)
    elif bd.mixer == "mlstm":
        s["mixer"] = _mlstm_spec(cfg)
    elif bd.mixer == "slstm":
        s["mixer"] = _slstm_spec(cfg)
    if bd.ffn != "none":
        s["norm2"] = _norm_spec(cfg.norm)
        if bd.ffn == "dense":
            s["ffn"] = _mlp_spec(cfg.gated_mlp)
        else:
            s["ffn"] = _moe_spec(cfg)
            if bd.ffn == "dense_moe":
                s["ffn_dense"] = _mlp_spec(cfg.gated_mlp)
    return s


def _periods(layout, block):
    """One spec tree a period: a list over the segment's periods of a
    tuple of block specs (the port's parameter and cache layout)."""
    return [[tuple(block(bd) for bd in pat) for _ in range(n)]
            for pat, n in layout]


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {
        "embed": P(TP, None),
        "final_norm": _norm_spec(cfg.norm),
        "segments": _periods(cfg.segments(), lambda bd: _block_spec(bd, cfg)),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = P(None, TP)
    if cfg.enc_layers:
        s["enc_segments"] = _periods(cfg.enc_segments(),
                                     lambda bd: _block_spec(bd, cfg))
        s["enc_final_norm"] = _norm_spec(cfg.norm)
    if cfg.frontend and cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
        s["frontend_proj"] = P()
    if cfg.mtp:
        s["mtp"] = {"proj": P(None, None), "norm_h": _norm_spec(cfg.norm),
                    "norm_e": _norm_spec(cfg.norm),
                    "block": _block_spec(cfg.pattern[-1], cfg)}
    return s


# -- inputs, caches, optimizer ---------------------------------------------

def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _batch_spec(mesh, b: int):
    sizes = mesh_sizes(mesh)
    ax = batch_axes(mesh)
    total = math.prod(sizes[a] for a in ax) if ax else 1
    return ax if ax and b % total == 0 else None


def input_specs_for(cfg: ModelConfig, shape: ShapeConfig, mesh
                    ) -> Dict[str, Any]:
    """Specs of `configs.registry.input_specs`' tree."""
    ba = _batch_spec(mesh, shape.global_batch)
    tok = P(ba, None)
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = tok
        if shape.kind == "train":
            out["targets"] = tok
        if cfg.frontend:
            out["frontend_embeds"] = P(ba, None, None)
    else:
        out["token"] = tok
        out["cache"] = cache_specs(cfg, shape.global_batch, shape.seq_len,
                                   mesh)
    return out


def cache_specs(cfg: ModelConfig, b: int, cache_len: int, mesh):
    ba = _batch_spec(mesh, b)
    tp = mesh_sizes(mesh)[TP]

    def kv(length):
        if cfg.num_kv_heads % tp == 0:
            return {"k": P(ba, TP, None, None), "v": P(ba, TP, None, None)}
        if length % tp == 0:
            return {"k": P(ba, None, TP, None), "v": P(ba, None, TP, None)}
        return {"k": P(ba, None, None, None), "v": P(ba, None, None, None)}

    def block(bd: BlockDef):
        if bd.mixer in ("attn", "bidir"):
            return kv(cache_len)
        if bd.mixer == "swa":
            return kv(min(cfg.window, cache_len))
        if bd.mixer == "mla":
            lat = P(ba, TP, None) if cache_len % tp == 0 else P(ba, None, None)
            return {"ckv": lat, "krope": lat}
        if bd.mixer == "dec":
            s = kv(cache_len)
            s.update(xk=P(ba, None, None, None), xv=P(ba, None, None, None))
            return s
        if bd.mixer == "xattn":
            return {"xk": P(ba, None, None, None),
                    "xv": P(ba, None, None, None)}
        if bd.mixer == "rglru":
            w = cfg.rec_width or cfg.d_model
            wsp = TP if w % tp == 0 else None
            return {"h": P(ba, wsp), "conv": P(ba, None, wsp)}
        if bd.mixer == "mlstm":
            dh = 2 * cfg.d_model // cfg.num_heads
            dsp = TP if dh % tp == 0 else None
            return {"C": P(ba, None, None, dsp), "n": P(ba, None, dsp),
                    "m": P(ba, None)}
        if bd.mixer == "slstm":
            dsp = TP if cfg.d_model % tp == 0 else None
            return {"c": P(ba, dsp), "n": P(ba, dsp), "h": P(ba, dsp),
                    "m": P(ba, dsp)}
        raise ValueError(bd.mixer)

    return {"pos": P(), "segments": _periods(cfg.segments(), block)}


def logits_spec(mesh, b: int, vocab: Optional[int] = None):
    tp = TP if vocab is None or vocab % mesh_sizes(mesh)[TP] == 0 else None
    return P(_batch_spec(mesh, b), None, tp)


def zero1_specs(pspecs, params_abs, mesh):
    """Optimizer-state specs: each parameter's spec plus 'data' on its
    largest unsharded dimension that 'data' divides (ZeRO-1)."""
    dp = mesh_sizes(mesh).get("data", 1)

    def one(sp, leaf):
        dims = list(sp) + [None] * (len(leaf.shape) - len(sp))
        best, best_sz = None, 0
        for i, (d, cur) in enumerate(zip(leaf.shape, dims)):
            if cur is None and d % dp == 0 and d > best_sz:
                best, best_sz = i, d
        if best is not None and best_sz >= dp:
            dims[best] = "data"
        return P(*dims)

    return spec_map(one, pspecs, params_abs)


def opt_state_specs(pspecs, params_abs, mesh, zero1: bool = True):
    mv = zero1_specs(pspecs, params_abs, mesh) if zero1 else pspecs
    return {"m": mv, "v": mv, "count": P()}


def sanitize(spec_tree, abs_tree, mesh):
    """Drop each axis whose dimension its size does not divide (that
    dimension is then replicated): e.g. the odd vocabularies (Whisper
    51,866, MiniCPM 122,753) keep a replicated embedding."""
    sizes = mesh_sizes(mesh)

    def one(sp, leaf):
        dims = list(sp) + [None] * (len(leaf.shape) - len(sp))
        out = []
        for d, ax in zip(leaf.shape, dims):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            out.append(ax if d % math.prod(sizes[a] for a in axes) == 0
                       else None)
        return P(*out)

    return spec_map(one, spec_tree, abs_tree)


# -- DTensor placement --------------------------------------------------------

def placements(mesh, spec: P) -> Tuple:
    """A spec's DTensor placements on `mesh` (a DeviceMesh): Shard(d) on
    each mesh axis that dimension d names, Replicate on the others. A
    dimension over several axes, ("pod", "data"), is split over them in
    the mesh's order, major first, as JAX splits it."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """The tree of placements (`placements`) of a spec tree."""
    return spec_map(lambda sp: placements(mesh, sp), spec_tree)


def local_shape(shape, mesh, place) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(this rank's shard shape, its offset in the global tensor)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    ls, off = compute_local_shape_and_global_offset(torch.Size(shape), mesh,
                                                    list(place))
    return tuple(ls), tuple(off)


def _place(t, spec, mesh):
    if not isinstance(t, torch.Tensor):
        return t  # a host leaf (the optimizer's step count)
    place = placements(mesh, spec)
    ls, off = local_shape(t.shape, mesh, place)
    if t.device.type == "meta":
        loc = torch.empty(ls, dtype=t.dtype, device="meta")
    else:
        loc = t[tuple(slice(o, o + n) for o, n in zip(off, ls))].clone(
            memory_format=torch.contiguous_format)
    return DTensor.from_local(loc, mesh, place, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape, device="meta")
                              .stride())


def distribute(tree, specs, mesh):
    """`tree` placed as DTensors on `mesh` by `specs`: each rank keeps
    its own shard, sliced (a copy) from the whole tensor it holds, the
    same on every rank, with no communication; on the meta device each
    rank's shard is an empty meta tensor of its local shape. Host leaves
    (a spec'd step count) pass through."""
    return spec_map(lambda sp, t: _place(t, sp, mesh), specs, tree)


def local_bytes(tree) -> int:
    """Bytes this rank holds of `tree`'s tensors (a DTensor's shard)."""
    locs = [t.to_local() if isinstance(t, DTensor) else t
            for t in leaves(tree) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in locs)
