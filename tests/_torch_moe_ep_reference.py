"""The reference's expert-parallel MoE (`repro.distributed.moe_ep`) on
host devices, for tests/test_torch_moe_ep.py; run as a script in a
process of its own (8 host devices must be set before jax starts):

    python tests/_torch_moe_ep_reference.py IN.npz OUT.npz

IN.npz holds, for each architecture a, the MoE layer's leaves
("a/router", "a/w_up", "a/shared/w_gate", ...), its input "a/x" (B, S,
d) and the output cotangent "a/c", and "cells": a JSON list of [arch,
data, model, capacity factor]. For each cell i, OUT.npz holds the
layer's output "i/y" and the gradients of sum(y * c) "i/g/<leaf>" and
"i/g/x", from `layers.moe` with ``impl="ep_a2a"`` on a ("data",
"model") mesh of the first data * model devices. x goes in unsharded
and outside ``with mesh:``: the form that runs on jax 0.9
(tests/_moe_ep_script.py's, which shards x first, fails there in the
gather implementation).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.distributed.moe_ep import set_moe_mesh  # noqa: E402
from repro.models.layers import moe  # noqa: E402


def layer(inp, arch: str):
    """The layer's parameter tree, x and c of `arch` from IN.npz."""
    p = {}
    for name in inp.files:
        head, _, rest = name.partition("/")
        if head != arch or rest in ("x", "c"):
            continue
        *path, last = rest.split("/")
        node = p
        for k in path:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(inp[name])
    return p, jnp.asarray(inp[f"{arch}/x"]), jnp.asarray(inp[f"{arch}/c"])


def main(src: str, dst: str) -> None:
    inp = np.load(src)
    out = {}
    for i, (arch, dp, tp, cf) in enumerate(json.loads(str(inp["cells"]))):
        base = get_smoke_config(arch)
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf, impl="ep_a2a"))
        devices = np.array(jax.devices()[:dp * tp]).reshape(dp, tp)
        set_moe_mesh(Mesh(devices, ("data", "model")), ("data",), "model")
        p, x, c = layer(inp, arch)

        def run(p, x, c, cfg=cfg):
            y, back = jax.vjp(lambda p, x: moe(p, x, cfg), p, x)
            return y, back(c)

        y, (gp, gx) = jax.jit(run)(p, x, c)
        out[f"{i}/y"] = np.asarray(y)
        out[f"{i}/g/x"] = np.asarray(gx)
        for path, g in jax.tree_util.tree_leaves_with_path(gp):
            name = "/".join(k.key for k in path)
            out[f"{i}/g/{name}"] = np.asarray(g)
    set_moe_mesh(None)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
