"""The port's tree collectives (`repro_torch.core.tree_collectives`)
against the reference's, on the CPU over gloo.

One spawn of 8 ranks (`launch.mesh.spawn`, `tests/torch_sharded_ranks.py`
`tree_rank`) runs `tree_reduce`, `tree_broadcast` and `tree_all_reduce`
on the groups of the first 2, 4 and 8 ranks; one subprocess runs the
reference's `shard_map` collectives on meshes of 2, 4 and 8 of its 8
host devices over the same float32 and bfloat16 inputs. Every rank's
result must be bit-identical to the reference's shard of that rank —
the sums depend on the order of the additions — and, integers too, to
`schedule_replay`, the host replay of the schedule.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import tree_collectives as T
from repro_torch.launch.mesh import spawn
from tests import torch_sharded_ranks as R

SIZES = (2, 4, 8)
WORLD = 8


def _inputs() -> dict:
    """Per-rank (3, 5) values: float32 over eight decades (the order of
    additions shows), bfloat16 from them, and integers."""
    rng = np.random.default_rng(0)
    f = (rng.standard_normal((WORLD, 3, 5))
         * 10.0 ** rng.uniform(-4, 4, (WORLD, 3, 5))).astype(np.float32)
    bf = torch.from_numpy(f).to(torch.bfloat16).view(torch.int16).numpy()
    ints = rng.integers(-2**20, 2**20, (WORLD, 3, 5)).astype(np.int64)
    return {"float32": f, "bfloat16": bf, "int": ints}


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.nice(10)  # beside the test run's workers, as the spawned ranks are
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import warnings; warnings.simplefilter("ignore")
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.tree_collectives import (
        tree_broadcast, tree_reduce, shard_map as sm)
    src = np.load(sys.argv[1])
    out = {}
    for p in (2, 4, 8):
        mesh = Mesh(np.asarray(jax.devices()[:p]), ("pod",))
        f = src["float32"][:p]
        x = jnp.asarray(f.reshape((-1,) + f.shape[2:]))
        h = jnp.asarray(src["bfloat16"][:p].view(np.uint16)).view(
            jnp.bfloat16).reshape(x.shape)

        def run(x, h):
            # tree_all_reduce is tree_broadcast(tree_reduce(.)): the
            # reduced value is broadcast here rather than reduced twice
            rx, rh = tree_reduce(x, "pod", p), tree_reduce(h, "pod", p)
            return (rx, tree_broadcast(x, "pod", p),
                    tree_broadcast(rx, "pod", p), rh,
                    tree_broadcast(h, "pod", p),
                    tree_broadcast(rh, "pod", p))

        ys = iter(sm(run, mesh=mesh, in_specs=(P("pod"),) * 2,
                     out_specs=(P("pod"),) * 6, check_vma=False)(x, h))
        for name in ("float32", "bfloat16"):
            for op in ("reduce", "broadcast", "all_reduce"):
                y = np.asarray(next(ys))
                if name == "bfloat16":
                    y = y.view(np.uint16).view(np.int16)
                out[f"{p}/{name}/{op}"] = y.reshape(f.shape)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, reference results, every rank's port results)."""
    tmp = tmp_path_factory.mktemp("tree")
    xs = _inputs()
    np.savez(tmp / "in.npz", **xs)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
                        str(tmp / "ref.npz")], capture_output=True,
                       text=True, env=env, timeout=300)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    ref = dict(np.load(tmp / "ref.npz"))
    got = spawn(R.tree_rank, WORLD, "gloo", "cpu", xs, SIZES, timeout=300.0)
    return xs, ref, got


@pytest.mark.parametrize("p", SIZES)
def test_bit_identical_to_the_reference(runs, p):
    """float32 and bfloat16 against the reference's shards (the integer
    sums, exact in any order, are held to the host replay below)."""
    xs, ref, got = runs
    for name in ("float32", "bfloat16"):
        for op in ("reduce", "broadcast", "all_reduce"):
            want = ref[f"{p}/{name}/{op}"]
            for rank in range(p):
                np.testing.assert_array_equal(
                    got[rank][(p, name, op)], want[rank],
                    err_msg=f"P={p} {name} {op} rank {rank}")
    for rank in range(p, WORLD):  # outside the group: nothing ran
        assert not any(k[0] == p for k in got[rank])


@pytest.mark.parametrize("p", SIZES)
def test_host_replay_of_the_schedule(runs, p):
    """`schedule_replay` (the oracle chip_smoke holds the card to) gives
    the same bits, and the all-reduce is a sum."""
    xs, _, got = runs
    for name, arr in xs.items():
        ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arr[:p]]
        if name == "bfloat16":
            ts = [t.view(torch.bfloat16) for t in ts]
        for op in ("reduce", "broadcast", "all_reduce"):
            for rank, y in enumerate(T.schedule_replay(ts, op)):
                y = y.view(torch.int16) if name == "bfloat16" else y
                np.testing.assert_array_equal(got[rank][(p, name, op)],
                                              y.numpy())
    total = xs["int"][:p].sum(0)
    for rank in range(p):
        np.testing.assert_array_equal(got[rank][(p, "int", "all_reduce")],
                                      total)


def test_one_rank_and_non_power_of_two():
    x = torch.arange(4.0)
    assert T.schedule_replay([x], "all_reduce")[0] is x
    with pytest.raises(ValueError, match="2\\^k"):
        T.schedule_replay([x, x, x], "reduce")
    # parent(i) is the owner of UP at rank i's address, i * 2^d / P
    from repro_torch.core import addressing as A

    for p in SIZES:
        s = (1 << 32) // p
        for i in range(1, p):
            up = int(A.up(np.asarray(i * s, np.uint64), 32))
            assert T._parent(i, p) == up // s, (p, i)
