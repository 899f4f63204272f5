"""The ranks of tests/test_torch_moe_ep.py: the port's expert-parallel
MoE (`distributed.moe_ep`) on `torch.distributed` meshes, spawned by
`launch.mesh.spawn` on the CPU (gloo). Imports no jax.

`ep_cells(rank, world, device, cells, layers)` runs, for each cell
[arch, data, model, capacity factor] (in order; the ranks past data *
model sit it out), `layers.moe` with ``impl="ep_a2a"`` over a
("data", "model") mesh of the first data * model ranks: this rank's
token shard of ``layers[arch]``'s x (the batch split over "data"), its
experts (`shard_experts`), the loss sum(y * c) over its shard, then the
parameters' gradients summed over the data axis (the data-parallel
gradient sync). Returns, per cell, None or this rank's (coordinates, y,
x's gradient, every leaf's gradient, the pairs dropped at the send
capacity and at the expert capacity)."""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import moe_ep as EP
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import layers as L
from repro_torch.tree import leaves, tree_map, unflatten


def _cell(mesh, arch: str, cf: float, layer: dict) -> dict:
    base = get_smoke_config(arch)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf, impl="ep_a2a"))
    d, dp = mesh.index("data"), mesh.shape["data"]
    x, c = (torch.from_numpy(layer[n]) for n in ("x", "c"))
    bl = x.shape[0] // dp
    p = EP.shard_experts(tree_map(torch.from_numpy, layer["p"]), mesh)
    p = tree_map(lambda t: t.clone().requires_grad_(), p)
    xl = x[d * bl:(d + 1) * bl].clone().requires_grad_()
    routing = {}
    y = L.moe(p, xl, cfg, routing)
    flat = leaves(p)
    grads = torch.autograd.grad((y * c[d * bl:(d + 1) * bl]).sum(),
                                [xl] + flat, allow_unused=True)
    gp = [torch.zeros_like(t) if g is None else g for t, g in
          zip(flat, grads[1:])]
    for g in gp:
        dist.all_reduce(g, group=mesh.group("data"))
    return {"coords": mesh.coords, "y": y.detach().numpy(),
            "gx": grads[0].numpy(),
            "g": tree_map(lambda g: g.numpy(), unflatten(p, gp)),
            "dropped": (int((~routing["keep"]).sum()),
                        int(routing["received"] - routing["kept"]))}


def ep_cells(rank: int, world: int, device, cells, layers) -> list:
    out = []
    meshes = {}
    for arch, dp, tp, cf in cells:
        if (dp, tp) not in meshes:
            meshes[dp, tp] = make_process_mesh((dp, tp),
                                               ranks=range(dp * tp))
        mesh = meshes[dp, tp]
        if mesh is None:
            out.append(None)
            continue
        EP.set_moe_mesh(mesh)
        try:
            out.append(_cell(mesh, arch, cf, layers[arch]))
        finally:
            EP.set_moe_mesh(None)
    return out
