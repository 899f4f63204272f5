"""The control plane over the sharded engine, on the CPU over gloo: one
spawn of 4 ranks (`launch.mesh.spawn`, `tests/torch_sharded_ranks.py`
`control_rank`), held against `TorchEngine` in this process.

  * `ShardedTorchEngine.resize_mesh` through a harness schedule (majority,
    seed 118) with its own resize events and more put in, so that the
    engine goes 4 -> 2 -> 4 -> 1 -> 4 ranks: the gathered state equal to
    `TorchEngine`'s at every event boundary, and every rank's trajectory
    equal where it held lanes (ranks 1-3 hold none while the engine sits
    on rank 0 alone);
  * the sharded server: a `SERVE_GRID` schedule through a
    `ThresholdServer` over the sharded engine of ranks 0 and 1 (a
    `dist.new_group`; rank 0 owns the ingestion ring and relays the
    churn and each window's batch) gives the transition stream, the
    trace, the counters and the end state of a server over `TorchEngine`;
  * `EngineSuspicionBridge` over an armed sharded engine of 4 ranks
    through a crash: on every rank the same plans, suspects and monitor
    table as over `TorchEngine`, and its planned rejoin is the eviction.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.dht import Ring
from repro_torch.engine import get_problem, make_engine
from repro_torch.launch.mesh import spawn
from tests import _diff_harness as H
from tests import torch_sharded_ranks as R

WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _resize_spec() -> dict:
    spec = R.spec_of(H.make_schedule("majority", 118, churn=True),
                     H.make_problem("majority"))
    ev = spec["events"]
    assert [e[0] for e in ev].count("resize") == 2
    spec["events"] = ([("resize", 2), ev[0], ("resize", 4)] + ev[1:]
                      + [("resize", 4)])
    return spec


def _serve_spec() -> dict:
    name, seed = H.SERVE_GRID[0]
    s = H.make_serve_schedule(name, seed)
    ring = Ring.random(s["n"], s["d"], seed=s["ring_seed"])
    return dict(addrs=np.asarray(ring.addrs), d=s["d"], problem=name,
                problem_kw=R.problem_kw(H.make_problem(name)), data=s["data"],
                eng_seed=s["eng_seed"], workload=s["workload"])


@pytest.fixture(scope="module")
def ranks():
    resize, serve = _resize_spec(), _serve_spec()
    got = spawn(R.control_rank, WORLD, "gloo", "cpu", resize, serve,
                timeout=300.0)
    return resize, serve, got


def test_resize_mesh_4_2_4_1_4_equals_torch_engine(ranks):
    spec, _, got = ranks
    sizes = [min(e[1], WORLD) for e in spec["events"] if e[0] == "resize"]
    assert sizes == [2, 4, 4, 1, 4]
    want = R.replay(R.build(spec, "cpu", 0), spec)
    R.assert_same_replay(want, [g["resize"] for g in got], "resize_mesh")
    # while the engine sat on rank 0 alone, ranks 1-3 held no lanes
    i = [k for k, e in enumerate(spec["events"]) if e[0] == "resize"][3]
    for g in got[1:]:
        assert g["resize"]["wheel"][i + 1] is None
        assert g["resize"]["active"]


def test_sharded_server_world2_equals_single_server(ranks):
    _, spec, got = ranks
    eng = make_engine("torch", Ring(spec["addrs"], spec["d"]), spec["data"],
                      seed=spec["eng_seed"], device="cpu",
                      problem=get_problem(spec["problem"]))
    want = R.serve_replay(eng, spec)
    lead, follow = got[0]["serve"], got[1]["serve"]
    assert lead["transitions"] == want["transitions"]
    assert len(want["transitions"]) > 0
    assert lead["serve"] == want["serve"]
    # a follower applies the relayed batches; the ring's counters are
    # rank 0's alone
    assert {k: v for k, v in follow["serve"].items()
            if k not in ("submitted", "coalesced")} == {
        k: v for k, v in want["serve"].items()
        if k not in ("submitted", "coalesced")}
    for g in (lead, follow):
        assert g["trace"] == want["trace"]
        for k in ("cycles", "messages"):
            assert g[k] == want[k], k
        for k in ("outputs", "data", "addrs"):
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)
        for k, v in want["state"].items():
            np.testing.assert_array_equal(g["state"][k], v, err_msg=k)
    assert "serve" not in got[2] and "serve" not in got[3]


def test_bridge_over_the_sharded_engine(ranks):
    got = ranks[2]
    want = R.bridge_log(R.bridge_engine("cpu"))
    log, last_seen, evictions = want
    assert [a for _, a in evictions] == [plan[0] for plan in log[2][0]]
    for g in got:
        assert g["bridge"] == want


def test_resize_mesh_argument_checks(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        eng = make_engine("torch", Ring.random(20, 32, seed=1),
                          np.ones(20, np.int64), device="cpu", mesh=True)
        for k in (0, 2, 3):
            with pytest.raises(ValueError, match="power of two"):
                eng.resize_mesh(k)
        eng.resize_mesh(1)  # no change
        eng.resize_mesh(True)
        assert eng.active and eng.n_shards == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
