"""The ranks of tests/test_torch_sp_step.py: the sharding plan's step on a
("data", "model") `DeviceMesh` of the job's ranks, spawned by
`launch.mesh.spawn` (gloo on the CPU). Imports no jax.

`plan_cells(rank, world, device, data, model, cells)` builds
`launch.mesh.make_mesh(data, model)` and, for each (name, arch, batch,
seq, overrides, mesh) cell, on `make_mesh(*mesh)` (that mesh when None),
float32 at the smoke config's widths with `overrides` replaced in it:
the same seeded parameters
and batch on every rank; one plain `make_train_step` step on the whole
tensors, and one on them placed by the plan (`sharding.distribute` of
`sanitize(param_specs)`, ZeRO-1 `opt_state_specs`, `input_specs_for`);
then a prefill of the first seq - 1 tokens (plain) into a cache of seq
positions, placed by `cache_specs`, and one decode step of the last
token, plain and placed. Also `sp.seq_constraint` on a placed (B, S, d)
activation. Returns, per cell, the plain and placed losses and gradient norms, the
largest parameter difference (every leaf gathered), the decode logits'
difference relative to their largest entry, the new cache entries'
difference, the placements seen, how the attention was split over the
TP axis (`plan.attn_split`) and whether KV heads were repeated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import sp
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import plan
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.tree import leaves, tree_map


def _copy(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def _cell(mesh, arch: str, b: int, s: int, overrides: dict) -> dict:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **overrides)
    params = init_params(cfg, 3, "cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32))
    targets = torch.from_numpy(rng.integers(-1, cfg.vocab_size, (b, s))
                               .astype(np.int32))
    step = S.make_train_step(cfg, AdamWConfig())
    p1, _, m1 = step(_copy(params), init_state(params), tokens, targets)

    pspecs = shd.sanitize(shd.param_specs(cfg), params, mesh)
    dp = shd.distribute(params, pspecs, mesh)
    ospecs = shd.opt_state_specs(pspecs, params, mesh)
    do = shd.distribute(init_state(params), ospecs, mesh)
    ins = shd.distribute({"tokens": tokens, "targets": targets},
                         shd.input_specs_for(cfg, ShapeConfig("t", "train",
                                                              s, b), mesh),
                         mesh)
    p2, o2, m2 = step(dp, do, ins["tokens"], ins["targets"])
    perr = max(float((a.full_tensor() - w).abs().max())
               for a, w in zip(leaves(p2), leaves(p1)))

    # decode (the step above updated dp in place): the last token against
    # a prefill of the others, plain and placed (the cache split over
    # heads or over its sequence)
    prefill = S.make_prefill_step(cfg, cache_len=s)
    _, cache = prefill(params, tokens[:, :-1])
    cspecs = shd.sanitize(shd.cache_specs(cfg, b, s, mesh), cache, mesh)
    dcache = shd.distribute(_copy(cache), cspecs, mesh)
    decode = S.make_decode_step(cfg)
    want, _ = decode(params, tokens[:, -1:], cache)
    tok = shd.distribute({"t": tokens[:, -1:]},
                         {"t": shd.P(shd.batch_axes(mesh), None)}, mesh)
    got, dcache = decode(shd.distribute(params, pspecs, mesh), tok["t"],
                         dcache)
    derr = float((got.full_tensor() - want).abs().max() / want.abs().max())
    kv = dcache["segments"][0][0][0]["k"]
    cache_err = float((kv.full_tensor()
                       - cache["segments"][0][0][0]["k"]).abs().max())
    return {"loss": [float(m1["loss"]), float(m2["loss"].full_tensor())],
            "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "param_err": perr, "decode_err": derr, "cache_err": cache_err,
            "cache_placements": [str(p) for p in kv.placements],
            "attn_split": plan.attn_split(
                mesh, cfg.num_heads, cfg.num_kv_heads,
                b // mesh["data"].size()),
            "kv_repeat": cfg.num_kv_heads % mesh["model"].size() != 0,
            "m_placements": [str(p) for p in
                             leaves(o2["m"])[0].placements]}


def _seq(mesh) -> dict:
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 8, 6)).astype(np.float32))
    dx = shd.distribute({"x": x}, {"x": shd.P("data", None, None)},
                        mesh)["x"]
    sp.set_sp_axes(("data",), "model")
    try:
        y = sp.seq_constraint(dx)
        odd = sp.seq_constraint(shd.distribute(
            {"x": x[:, :7]}, {"x": shd.P("data", None, None)}, mesh)["x"])
    finally:
        sp.set_sp_axes(None)
    named = shd.named(mesh, {"a": [shd.P(None, ("data",), "model")]})
    return {"placements": [str(p) for p in y.placements],
            "named": [str(p) for p in named["a"][0]],
            "odd": [str(p) for p in odd.placements],
            "equal": bool(torch.equal(y.full_tensor(), x)),
            "plain": sp.seq_constraint(x) is x}


def plan_cells(rank: int, world: int, device, data: int, model: int,
               cells) -> dict:
    mesh = make_mesh(data, model)
    out = {"seq": _seq(mesh)}
    for name, arch, b, s, overrides, shape in cells:
        out[name] = _cell(mesh if shape is None else make_mesh(*shape),
                          arch, b, s, overrides)
    return out
