"""The port's expert-parallel MoE dispatch (`distributed.moe_ep`, the
``impl="ep_a2a"`` route of `layers.moe`) against the reference's
`repro.distributed.moe_ep`, on the CPU.

One gloo job of 4 ranks (`launch.mesh.spawn`, running
tests/torch_moe_ep_ranks.py, which imports no jax) lays out ("data",
"model") meshes of (1, 2), (1, 4) and (2, 2) ranks
(`launch.mesh.make_process_mesh`); the reference runs its `shard_map`
on the same meshes of 8 host devices in one subprocess
(tests/_torch_moe_ep_reference.py), at the same time. Both MoE smoke
layers (DeepSeek-V3's sigmoid router with a drawn selection bias and a
shared expert; Arctic's softmax router), at capacity factor 8 (nothing
dropped) and at the config's own 1.5 (pairs dropped, at the send
capacity or at an expert's, asserted), over 4 x 16 tokens.

Parameters are the port's `init_moe` (seeded) with ``router_bias``
drawn from N(0, 0.5^2); inputs and the output cotangent c are seeded
numpy, every token of x with one direction added (which crowds the
routers).
Each rank computes its data shard's output from its own experts; the
gradients of sum(y * c) are summed over the data axis (the trainer's
data-parallel sync). Bounds: every rank's output within 1e-5 of the
reference's max |y| (max |a - b| / max |b|), and every gradient, x's
and the replicated leaves' (``router``, ``shared``) too, within 1e-5
relative in L2; ``router_bias``'s is zero on both sides.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("deepseek-v3-671b", "arctic-480b")
MESHES = ((1, 2), (1, 4), (2, 2))
BOUND = 1e-5


def _layers() -> dict:
    """Each architecture's MoE layer (numpy leaves), x (4, 16, d) and c."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)
        p = L.init_moe(torch.Generator().manual_seed(11 + i), cfg,
                       torch.float32)
        p = tree_map(lambda t: t.numpy(), p)
        rng = np.random.default_rng(21 + i)
        p["router_bias"] = (0.5 * rng.standard_normal(
            p["router_bias"].shape)).astype(np.float32)
        draw = lambda: rng.standard_normal((4, 16, cfg.d_model))
        # a direction every token shares crowds the routers onto a few
        # experts: pairs drop at the config's own capacity factor
        x = draw() + rng.standard_normal(cfg.d_model)
        out[arch] = {"p": p, "x": x.astype(np.float32),
                     "c": draw().astype(np.float32)}
    return out


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {n: a for k, v in tree.items()
                for n, a in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _cells():
    return [[arch, dp, tp, cf] for dp, tp in MESHES for arch in ARCHS
            for cf in (8.0, get_smoke_config(arch).moe.capacity_factor)]


def test_moe_ep_matches_reference_on_meshes(tmp_path):
    layers, cells = _layers(), _cells()
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, cells=json.dumps(cells), **{
        f"{arch}/{n}": a for arch, lay in layers.items()
        for n, a in _flat({"x": lay["x"], "c": lay["c"],
                           **lay["p"]}).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_moe_ep_reference.py"),
         str(src), str(dst)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        sys.path.insert(0, HERE)
        from torch_moe_ep_ranks import ep_cells
        got = spawn(ep_cells, 4, "gloo", "cpu", cells, layers, timeout=300)
    finally:
        sys.path.remove(HERE)
        log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log
    want = np.load(dst)
    for i, (arch, dp, tp, cf) in enumerate(cells):
        ranks = got[:dp * tp]
        assert all(r[i] is None for r in got[dp * tp:])
        bl = 4 // dp
        wy, wx = want[f"{i}/y"], want[f"{i}/g/x"]
        n = get_smoke_config(arch).moe.n_experts // tp
        dropped = np.sum([r[i]["dropped"] for r in ranks], axis=0)
        for r in ranks:
            (d, m), cell = r[i]["coords"], f"{arch} mesh {(dp, tp)} cf {cf}"
            sl = slice(d * bl, (d + 1) * bl)
            err = np.abs(r[i]["y"] - wy[sl]).max() / np.abs(wy).max()
            assert err <= BOUND, (cell, err)
            g = {"x": r[i]["gx"], **_flat(r[i]["g"])}
            w = {"x": wx[sl]}
            for name, a in _flat(layers[arch]["p"]).items():
                b = want[f"{i}/g/{name}"]
                w[name] = b[m * n:(m + 1) * n] if name.startswith("w_") \
                    else b
                assert w[name].shape == g[name].shape, (cell, name)
            assert sorted(g) == sorted(w)
            assert not g["router_bias"].any() and not w["router_bias"].any()
            for name in g:
                if name == "router_bias":
                    continue
                e = np.linalg.norm(g[name] - w[name])
                assert e <= BOUND * np.linalg.norm(w[name]), (cell, name, e)
        if cf == 8.0:
            assert dropped.sum() == 0, (arch, dp, tp, dropped)
        else:
            assert dropped.sum() > 0, (arch, dp, tp)


def test_no_mesh_and_small_batches_take_the_gather_implementation():
    """``impl="ep_a2a"`` with no mesh, and with a mesh but fewer of the
    rank's tokens than expert ranks (a decode batch), runs the gather
    implementation: bit for bit its output (the reference's rule,
    src/repro/models/layers.py:390-402). The mesh here is never reached
    for a collective."""
    from repro_torch.distributed import moe_ep as EP
    from repro_torch.launch.mesh import ProcessMesh

    arch = ARCHS[0]
    cfg = get_smoke_config(arch)
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          impl="ep_a2a"))
    lay = _layers()[arch]
    p = tree_map(torch.from_numpy, lay["p"])
    x = torch.from_numpy(lay["x"])
    assert torch.equal(L.moe(p, x, ep), L.moe(p, x, cfg))
    EP.set_moe_mesh(ProcessMesh(("data", "model"), (1, 4), (0, 0),
                                (None, None)))
    try:
        small = x[:1, :3]
        assert torch.equal(L.moe(p, small, ep), L.moe(p, small, cfg))
    finally:
        EP.set_moe_mesh(None)
    assert EP.current_moe_mesh()[0] is None
