"""The sharded engine (`repro_torch.engine.sharded`) on the CPU, over gloo.

`ShardedTorchEngine` must be bit-identical to `TorchEngine` at every
world size: the whole state, gathered from the ranks, equal field by
field at every event boundary, and the trajectory (cycles, messages, the
wheel-occupancy trace, outputs, data) equal on every rank.

  * world 1 in this process (a `FileStore` group) through `set_votes`,
    churn and a re-pad (`_grow`);
  * worlds 2, 4 and 8, one spawned process a rank
    (`launch.mesh.spawn`), on the differential harness's majority churn
    schedule; mean, L2 and the `majority_step` route at world 2; joins
    past the pad (the re-pad, the host gathers in small slices) at
    worlds 2 and 4;
  * the partition itself against the reference's: rank r's blocks equal
    `ShardedJaxEngine`'s addressable shard r, leaf by leaf, at meshes 2
    and 4 (the reference in a subprocess with 8 host devices), and each
    rank holds exactly 1/W of every partitioned leaf;
  * the argument checks of `make_engine(mesh=)`, `make_engine_group`
    and the engine.

The fault plane's schedules are in tests/test_torch_sharded_faults.py.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.dht import Ring
from repro_torch.engine import make_engine
from repro_torch.engine.sharded import PARTITIONED, ShardedTorchEngine
from repro_torch.launch.mesh import make_engine_group, spawn
from tests import _diff_harness as H
from tests import torch_sharded_ranks as R

TIMEOUT = 300.0  # seconds a spawned world may take


@pytest.fixture
def world1():
    """A one-rank gloo group in this process, destroyed afterwards."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _spec(name: str, seed: int, **engine) -> dict:
    return R.spec_of(H.make_schedule(name, seed, churn=True),
                     H.make_problem(name), **engine)


_REPLAYS = {}


def _single(spec: dict, key) -> dict:
    """`TorchEngine`'s replay of `spec` on the CPU (kept per schedule)."""
    if key not in _REPLAYS:
        _REPLAYS[key] = R.replay(R.build(spec, "cpu", 0), spec)
    return _REPLAYS[key]


def test_world1_in_process_matches_torch_engine(world1):
    """One rank: equal to the single engine after the init storm, every
    step, a data change, joins past the pad (the re-pad), a leave and
    the reconvergence."""
    n = 56
    ring = Ring.random(n, 32, seed=4)
    votes = (np.arange(n) % 3 == 0).astype(np.int64)
    a = make_engine("torch", ring, votes, seed=9, device="cpu")
    b = make_engine("torch", ring, votes, seed=9, device="cpu", mesh=True)
    assert isinstance(b, ShardedTorchEngine) and b.n_shards == 1

    def same(where):
        sa, sb = a.global_state(), b.global_state()
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), (where, k)

    same("after the init storm")
    free = np.setdiff1d(np.arange(1, 1 << 12), ring.addrs)[::97][:10]
    for step, op in [(15, ("set", np.arange(0, n, 2))),
                     *[(3, ("join", int(x))) for x in free],
                     (10, ("leave", 5))]:
        for e in (a, b):
            e.step(step)
            if op[0] == "set":
                e.set_votes(op[1], 1 - e.votes()[op[1]])
            elif op[0] == "join":
                e.join(op[1], vote=int(op[1]) % 2)
            else:
                e.leave(op[1])
        same(f"after {op[0]}")
    assert b.pad == a.pad > 64  # the joins re-padded both
    v = a.votes()
    ra, rb = (e.run_until_converged(truth=int(2 * v.sum() >= v.size))
              for e in (a, b))
    assert ra == rb and ra["converged"] == 1.0
    same("after the reconvergence")
    assert a.check_conservation() == b.check_conservation()
    np.testing.assert_array_equal(a.outputs(), b.outputs())
    # resumed from the global state (the reference's layout), in step
    c = ShardedTorchEngine.from_state(a.ring, b.global_state(), mesh=True,
                                      device="cpu", pad_to=b.pad)
    for e in (a, c):
        e.step(7)
    sc = c.global_state()
    for k, v in a.global_state().items():
        assert np.array_equal(v, sc[k]), ("from_state", k)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_majority_churn_every_world(world):
    spec = _spec("majority", 101)
    got = spawn(R.replay_rank, world, "gloo", "cpu", spec, timeout=TIMEOUT)
    R.assert_same_replay(_single(spec, "majority"), got, f"world {world}")


@pytest.mark.parametrize("name,seed", [("mean", 202), ("l2", 303)])
def test_problems_world2(name, seed):
    spec = _spec(name, seed)
    got = spawn(R.replay_rank, 2, "gloo", "cpu", spec, timeout=TIMEOUT)
    R.assert_same_replay(_single(spec, name), got, name)


def test_majority_step_route_world2():
    """A majority engine without the threshold kernel reacts through
    `majority_step`; sharded as on one device."""
    spec = _spec("majority", 101, wheel_kernels=("dedup", "enqueue",
                                                 "descent"))
    got = spawn(R.replay_rank, 2, "gloo", "cpu", spec, timeout=TIMEOUT)
    R.assert_same_replay(_single(spec, "majority_step"), got, "majority_step")


def _repad_spec() -> dict:
    """56 peers (pad 64) and the events of the world-1 test: a data
    change, ten joins past the pad (the re-pad to 128), a leave; the
    host gathers in slices of 4 KiB, so the wheel goes in many."""
    n = 56
    ring = Ring.random(n, 32, seed=4)
    free = np.setdiff1d(np.arange(1, 1 << 12), ring.addrs)[::97][:10]
    events = [("step", 15), ("set", np.arange(0, n, 2),
                             (np.arange(0, n, 2) % 3 != 0).astype(np.int64))]
    for x in free:
        events += [("step", 3), ("join", int(x), int(x) % 2)]
    events += [("step", 10), ("leave", 5)]
    return dict(addrs=np.asarray(ring.addrs), d=32, problem="majority",
                problem_kw={}, data=(np.arange(n) % 3 == 0).astype(np.int64),
                eng_seed=9, faults=None, engine={}, events=events,
                gather_bytes=4096)


@pytest.mark.parametrize("world", [2, 4])
def test_repad_every_world(world):
    """Joins past the pad at worlds 2 and 4: every rank gathers the state
    to its host, re-pads it and keeps its blocks; equal to `TorchEngine`
    at every event boundary, the re-pad included."""
    spec = _repad_spec()
    got = spawn(R.replay_rank, world, "gloo", "cpu", spec, timeout=TIMEOUT)
    want = _single(spec, "repad")
    assert want["pad"] == 128
    R.assert_same_replay(want, got, f"re-pad, world {world}")


# -- the partition against the reference's ---------------------------------

_SHARDS_SCRIPT = r"""
import json, sys
import numpy as np
from repro.core.dht import Ring
from repro.engine.sharded import ShardedJaxEngine

n, seed, cycles, meshes, out = json.loads(sys.argv[1])
ring = Ring.random(n, 32, seed=seed)
votes = (np.arange(n) % 3 == 0).astype(np.int64)
arrays = {}
for m in meshes:
    eng = ShardedJaxEngine(ring, votes, seed=seed + 1, mesh=m, kernel="ref",
                           wheel_kernels="none")
    eng.step(cycles)
    for leaf, arr in eng._st._asdict().items():
        for sh in arr.addressable_shards:
            i = sh.index[0].start if sh.index and sh.index[0].start else 0
            r = i // sh.data.shape[0] if sh.data.ndim else 0
            arrays[f"{m}/{leaf}/{sh.device.id}/{r}"] = np.asarray(sh.data)
np.savez(out, **arrays)
print("SHARDS_OK")
"""
PART = dict(n=96, seed=21, cycles=6)


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    """`ShardedJaxEngine(kernel="ref", wheel_kernels="none")` at meshes 2
    and 4 after the init storm and PART's cycles: {(mesh, leaf, r): the
    block of the shard at row-block index r} (replicated leaves: every
    device's copy)."""
    out = str(tmp_path_factory.mktemp("shards") / "shards.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.abspath(os.path.join(
                   os.path.dirname(__file__), "..", "src")))
    r = subprocess.run(
        [sys.executable, "-c", _SHARDS_SCRIPT,
         json.dumps([PART["n"], PART["seed"], PART["cycles"], [2, 4], out])],
        capture_output=True, text=True, env=env, timeout=600)
    assert "SHARDS_OK" in r.stdout, r.stdout + r.stderr
    got = {}
    with np.load(out) as z:
        for key in z.files:
            m, leaf, _, blk = key.split("/")
            got[(int(m), leaf, int(blk))] = z[key]
    return got


_PARTS = {}


def _rank_states(world: int):
    """Each rank's own blocks after the init storm and PART's cycles."""
    if world not in _PARTS:
        n, seed = PART["n"], PART["seed"]
        spec = dict(addrs=np.asarray(Ring.random(n, 32, seed=seed).addrs),
                    d=32, problem="majority", problem_kw={},
                    data=(np.arange(n) % 3 == 0).astype(np.int64),
                    eng_seed=seed + 1, faults=None, engine={}, events=[])
        _PARTS[world] = spawn(R.partition_rank, world, "gloo", "cpu", spec,
                              PART["cycles"], timeout=TIMEOUT)
    return _PARTS[world]


@pytest.mark.parametrize("world", [2, 4])
def test_partition_matches_reference_shards(world, reference_shards):
    """Rank r's blocks of every partitioned leaf equal the reference's
    shard r, and its replicas equal the reference's replicated leaves."""
    for r, got in enumerate(_rank_states(world)):
        for leaf, a in got["state"].items():
            want = reference_shards[(world, leaf,
                                     r if leaf in PARTITIONED else 0)]
            assert a.dtype == want.dtype and a.shape == want.shape, (
                world, r, leaf, a.shape, want.shape)
            assert np.array_equal(a, want), (world, r, leaf)


def test_each_rank_holds_one_quarter():
    """At world 4 every partitioned leaf is split four ways (each rank
    exactly 1/4 of its bytes) and every other leaf is whole on each."""
    ranks = _rank_states(4)
    full = {k: sum(g["state"][k].nbytes for g in ranks) for k in PARTITIONED}
    for g in ranks:
        assert g["lanes"] == 2 and g["rows"] * 4 == 128
        for k, a in g["state"].items():
            if k in PARTITIONED:
                assert a.nbytes * 4 == full[k], k
            else:
                assert a.nbytes == ranks[0]["state"][k].nbytes, k
    assert ranks[0]["state"]["wheel"].shape[0] == 2


# -- argument checks --------------------------------------------------------

def test_make_engine_mesh_errors(world1):
    ring = Ring.random(16, 32, seed=0)
    votes = np.zeros(16, np.int64)
    with pytest.raises(ValueError):
        make_engine("numpy", ring, votes, mesh=True)
    with pytest.raises(NotImplementedError):
        make_engine("torch", ring, votes, mesh=True, batch=2, device="cpu")
    with pytest.raises(ValueError):  # not the group's size
        make_engine("torch", ring, votes, mesh=2, device="cpu")
    with pytest.raises(ValueError):  # more ranks than the world
        make_engine_group(2)
    one = make_engine("torch", ring, votes, mesh=1, device="cpu")
    assert one.n_shards == 1


def test_group_checks_world4():
    """A group of 3 ranks and 2 lanes (a pad of 2 mod 4) over 4 ranks raise;
    `make_engine_group(3)` refuses a size that is not a power of two."""
    spec = _spec("majority", 101)
    errs = spawn(R.checks_rank, 4, "gloo", "cpu", spec, timeout=TIMEOUT)
    for r, e in enumerate(errs):
        assert "power of two" in e["make_engine_group(3)"], e
        assert "do not divide the 2 wheel lanes" in e["two lanes"], e
        if r < 3:
            assert "power of two" in e["group of 3"], e
