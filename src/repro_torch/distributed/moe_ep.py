"""Expert-parallel MoE with an explicit all-to-all dispatch (the port's
`repro.distributed.moe_ep`).

The reference runs this schedule inside one `shard_map` over a device
mesh; the port runs it in every process of a `torch.distributed` mesh
(`launch.mesh.make_process_mesh`), one process a rank, and the only
rows that cross between ranks are tokens':

  on each rank of an expert group (the mesh's expert axis, tp ranks):
    route its 1/tp slice of the group's tokens -> (dest rank, local
        expert, gate weight)
    pack rows into (tp, cap_s, d) per-destination buffers   [local scatter]
    all_to_all over the expert group                        [wire: rows]
    pack received rows into (E / tp, cap_e, d)              [local scatter]
    the local experts' SwiGLU in float32
    reverse the two packings + all_to_all                   [wire: rows]
    weighted combine at the source, then all_gather of the group's tokens

The capacities are the reference's: ``cap_s = int(t k / tp * cf) + 1``
rows a destination (t the rank's slice), ``cap_e = int(tp cap_s / (E /
tp)) + 1`` rows a local expert; a pair past either is dropped (its token
keeps its residual). So at a finite capacity factor the drops are not
the gather implementation's (`models.layers.moe`), and the router's
logits are a float32 product (`moe_ep.py:79` of the reference), where
the gather implementation rounds them to the activation dtype first.

SPMD contract (every rank of the mesh calls `moe_ep` alike):
  * x (B, S, d) is the rank's token shard, the same on every rank of its
    expert group (the data axis splits the batch, the expert axis does
    not), B S divisible by tp;
  * ``router``, ``router_bias`` and ``shared`` are the whole leaves, the
    same on every rank; ``w_gate`` / ``w_up`` / ``w_down`` hold the
    rank's E / tp experts (`shard_experts`), rank j of the group experts
    j E / tp onwards;
  * the output is the expert group's, the same on every rank of it, and
    so must be every rank's loss downstream.

Gradients: the reference's transpose sums the cotangents of the leaves
that are replicated over the expert axis (x, ``router``, ``shared``)
over that axis; here `_Replicated` all-reduces them over the expert
group in the backward, and the final all_gather's backward keeps the
rank's own slice of the (replicated) output gradient, where a
reduce-scatter would count it tp times. Summing over the data axis is
the trainer's data-parallel gradient sync, as for any other weight.

The mesh is a module-level context, as the reference's (the model
config stays hashable): `set_moe_mesh` before the forward, None to leave
the gather implementation to every call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models import layers as L

_CTX = {"mesh": None, "expert_axis": "model"}


def set_moe_mesh(mesh, expert_axis: str = "model") -> None:
    """Make `mesh` (a `launch.mesh.ProcessMesh`, or None) the one that
    ``impl="ep_a2a"`` MoE layers dispatch over, `expert_axis` its axis
    that holds the experts. (The reference also names the token axes,
    to find a device's share of a global batch; here every rank's x is
    its own share already.)"""
    _CTX["mesh"] = mesh
    _CTX["expert_axis"] = expert_axis


def current_moe_mesh():
    """(mesh, expert axis) as `set_moe_mesh` left them."""
    return _CTX["mesh"], _CTX["expert_axis"]


def shard_experts(p, mesh, expert_axis: str = "model"):
    """A MoE layer's parameters `p` (whole expert stacks) as this rank of
    `mesh` holds them: its E / tp experts of each stack (views), every
    other leaf as it is."""
    tp, j = mesh.shape[expert_axis], mesh.index(expert_axis)
    e = p["w_gate"].shape[0]
    if e % tp:
        raise ValueError(f"{e} experts do not split over {tp} ranks")
    n = e // tp
    return {k: (v[j * n:(j + 1) * n] if k in ("w_gate", "w_up", "w_down")
                else v) for k, v in p.items()}


class _Replicated(torch.autograd.Function):
    """The identity, for a tensor every rank of `group` holds alike; the
    backward sums its gradient over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block j of t (tp, ...) to rank j of `group`; block j of the result
    from rank j (the reference's ``all_to_all(x, ax, 0, 0, tiled=True)``)."""
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`_all_to_all`, differentiable: it is its own transpose."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _GatherTokens(torch.autograd.Function):
    """The group's token slices (T, d) each, rank order, as (tp T, d) on
    every rank; the backward keeps this rank's slice of the gradient,
    which every rank of the group holds alike."""

    @staticmethod
    def forward(ctx, y, group):
        tp, ctx.rank, ctx.t = (dist.get_world_size(group),
                               dist.get_rank(group), y.shape[0])
        parts = [torch.empty_like(y, memory_format=torch.contiguous_format)
                 for _ in range(tp)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.t:(ctx.rank + 1) * ctx.t], None


def moe_ep(p, x: torch.Tensor, cfg, routing: Optional[dict] = None
           ) -> torch.Tensor:
    """`models.layers.moe` for x (B, S, d), this rank's token shard, by
    the expert-parallel schedule over the current mesh's expert group
    (module docstring). With `routing`, a dict, the experts this rank's
    slice picked ("experts", (B S / tp, k)), which pairs the send
    capacity kept ("keep", same shape), and how many received rows
    reached an expert ("received", "kept": 0-d tensors) are written into
    it."""
    mesh, ax = current_moe_mesh()
    if mesh is None:
        raise RuntimeError("moe_ep: no mesh set (set_moe_mesh)")
    group, tp = mesh.group(ax), mesh.shape[ax]
    rank = dist.get_rank(group)
    mo = cfg.moe
    k, e_loc = mo.top_k, mo.n_experts // tp
    if mo.n_experts % tp or p["w_gate"].shape[0] != e_loc:
        raise ValueError(f"moe_ep: {tuple(p['w_gate'].shape)} expert stack "
                         f"on a rank of {tp}; want {mo.n_experts} / {tp} "
                         f"experts (shard_experts)")
    b, s, d = x.shape
    if (b * s) % tp:
        raise ValueError(f"moe_ep: {b * s} tokens do not split over {tp} "
                         f"expert ranks")
    t = b * s // tp
    xf = _Replicated.apply(x, group).reshape(b * s, d)[rank * t:(rank + 1) * t]
    router = _Replicated.apply(p["router"], group)

    tope, gatew = L.pick_experts(
        p, L.router_scores(xf.float() @ router.float(), cfg), cfg)

    flat_e = tope.reshape(-1)
    dest, local_e = flat_e // e_loc, flat_e % e_loc
    cap_s = int(t * k / tp * mo.capacity_factor) + 1
    slot = L.queue_slots(dest, tp)
    keep = slot < cap_s
    idx = torch.where(keep, dest * cap_s + slot, tp * cap_s)
    rows = xf[torch.arange(t * k, device=x.device) // k]
    send = L.pack_rows(rows, idx, tp * cap_s).view(tp, cap_s, d)
    # the local expert of each sent row; -1 marks an empty one
    send_id = L.pack_rows(local_e.to(torch.int32) + 1, idx, tp * cap_s) - 1
    recv = _AllToAll.apply(send, group).view(tp * cap_s, d)
    rl = _all_to_all(send_id.view(tp, cap_s), group).view(-1).long()

    rok = rl >= 0
    rl = torch.clamp(rl, min=0)
    # stage one applied the capacity factor; stage two is sized at the
    # mean load (the reference's Perf H5)
    cap_e = int(tp * cap_s / e_loc) + 1
    slot2 = L.queue_slots(rl, e_loc, rok.to(torch.int32))
    keep2 = rok & (slot2 < cap_e)
    idx2 = torch.where(keep2, rl * cap_e + slot2, e_loc * cap_e)
    out = L.expert_swiglu(p, L.pack_rows(recv, idx2, e_loc * cap_e).view(
        e_loc, cap_e, d))
    back = out.view(e_loc * cap_e, d)[torch.clamp(idx2, max=e_loc * cap_e - 1)]
    back = torch.where(keep2[:, None], back, 0.0).view(tp, cap_s, d)
    ret = _AllToAll.apply(back, group).view(tp * cap_s, d)

    y = ret[torch.clamp(idx, max=tp * cap_s - 1)]
    y = torch.where(keep[:, None], y, 0.0)
    y = y * gatew.reshape(-1)[:, None].to(y.dtype)
    y = y.view(t, k, d).sum(1)
    if mo.n_shared:
        shared = {n: _Replicated.apply(w, group)
                  for n, w in p["shared"].items()}
        y = y + L.mlp(shared, xf, "silu")
    if routing is not None:
        routing.update(experts=tope, keep=keep.view(t, k),
                       received=rok.sum(), kept=keep2.sum())
    return _GatherTokens.apply(y, group).view(b, s, d)
