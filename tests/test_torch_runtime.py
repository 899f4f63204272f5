"""The port's host control plane against the reference's, on the CPU.

  * the DHT lookup model (`core.dht.finger_tables`, `lookup_hops`) and the
    LiMoSense gossip baseline (`core.limosense`): equal arrays, equal
    `run_until_converged` dicts and equal outputs after every cycle;
  * `runtime.fault_tolerance` (`HeartbeatMonitor`, `RestartPolicy`,
    `StragglerTracker`) and `runtime.elastic` (`Membership`,
    `remesh_plan`) on the same calls;
  * the drills: `churn_drill` and `decision_latency_profile` with
    ``backend="torch"`` (CPU) equal to the reference's ``"jax"`` dicts, the
    numpy drills equal to the reference's numpy ones, and
    `_profile_from_trace` on a serve trace of the port's server;
  * `EngineSuspicionBridge` over a CPU `TorchEngine` and over the port's
    `NumpyEngine` through a crash, equal to the bridge over the
    reference's `JaxEngine` / `NumpyEngine` at every sync;
  * ROADMAP §C3's schedule, ``make_schedule("majority", 102055,
    faults="crash")``, as a fixed cell: the port's `NumpyEngine` equals
    the reference's (three evictions, 373 cycles) and the CPU
    `TorchEngine` equals `JaxEngine` (one eviction, 312 cycles). The two
    reference engines disagree on it; each port engine inherits its
    counterpart's answer.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import dht as r_dht
from repro.core import limosense as r_lim
from repro.runtime import elastic as r_el
from repro.runtime import fault_tolerance as r_ft
from repro_torch.core import dht, limosense
from repro_torch.runtime import elastic, fault_tolerance as ft
from tests import _diff_harness as H


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny engines (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the DHT lookup model and the gossip baseline ---------------------------

@pytest.mark.parametrize("n,d,symmetric", [(64, 10, False), (64, 10, True),
                                           (300, 32, True), (300, 64, False)])
def test_finger_tables_and_lookup_hops(n, d, symmetric):
    ring = dht.Ring.random(n, d, seed=3)
    rring = r_dht.Ring.random(n, d, seed=3)
    np.testing.assert_array_equal(ring.addrs, rring.addrs)
    f = dht.finger_tables(ring, symmetric)
    np.testing.assert_array_equal(f, r_dht.finger_tables(rring, symmetric))
    rng = np.random.default_rng(5)
    src = rng.integers(0, n, 500)
    tgt = rng.integers(0, 1 << min(d, 63), 500, dtype=np.uint64).astype(
        ring.addrs.dtype) & ring.addrs.dtype.type((1 << d) - 1)
    hops = dht.lookup_hops(ring, f, src, tgt, symmetric)
    np.testing.assert_array_equal(
        hops, r_dht.lookup_hops(rring, f, src, tgt, symmetric))
    assert hops.max() > 1


@pytest.mark.parametrize("send_prob", [1.0, 0.6])
def test_limosense_matches_reference(send_prob):
    n = 400
    votes = (np.random.default_rng(2).random(n) < 0.55).astype(np.int64)
    ring = dht.Ring.random(n, 32, seed=1)
    a = limosense.LiMoSenseSimulator(
        ring, votes, seed=4, params=limosense.GossipParams(send_prob))
    b = r_lim.LiMoSenseSimulator(
        r_dht.Ring.random(n, 32, seed=1), votes, seed=4,
        params=r_lim.GossipParams(send_prob))
    np.testing.assert_array_equal(a.fingers, b.fingers)
    for _ in range(30):  # per cycle, a vote change halfway
        if a.t == 15:
            idx = np.arange(0, n, 7)
            a.set_votes(idx, 1 - votes[idx])
            b.set_votes(idx, 1 - votes[idx])
        a.step()
        b.step()
        np.testing.assert_array_equal(a.outputs(), b.outputs())
        np.testing.assert_array_equal(a.s, b.s)
        np.testing.assert_array_equal(a.w, b.w)
    truth = int(2 * a.x.sum() >= n)
    got, want = a.run_until_converged(truth), b.run_until_converged(truth)
    assert got == want and got["converged"] == 1.0


# -- the host agents ---------------------------------------------------------

def test_agents_match_reference():
    mons = [m.HeartbeatMonitor(timeout_s=5.0) for m in (ft, r_ft)]
    pols = [m.RestartPolicy(max_restarts=3, backoff_s=0.5)
            for m in (ft, r_ft)]
    trs = [m.StragglerTracker(alpha=0.3, ratio=1.5) for m in (ft, r_ft)]
    rng = np.random.default_rng(0)
    seen = [[], []]
    for now in range(40):
        host = int(rng.integers(0, 6))
        dt = float(rng.gamma(2.0, 1.0)) * (3.0 if host == 4 else 1.0)
        for i in range(2):
            mons[i].beat(host, now=float(now))
            trs[i].record(host, dt)
            seen[i].append((mons[i].dead(now=now + 3.0), trs[i].stragglers(),
                            pols[i].next_delay() if now % 9 == 0 else None))
        if now == 30:
            for p in pols:
                p.reset()
    assert seen[0] == seen[1]
    assert any(s[0] for s in seen[0]) and any(s[1] for s in seen[0])


@pytest.mark.parametrize("hosts", [1, 2, 8, 12, 32])
def test_membership_and_remesh_plan(hosts):
    a, b = elastic.Membership(list(range(hosts))), \
        r_el.Membership(list(range(hosts)))
    np.testing.assert_array_equal(a.ring().addrs, b.ring().addrs)
    for x, y in zip(a.tree_neighbors(), b.tree_neighbors()):
        np.testing.assert_array_equal(x, y)
    if hosts > 1:
        assert [a.affected_by_leave(r) for r in range(hosts)] == \
            [b.affected_by_leave(r) for r in range(hosts)]
    assert a.affected_by_join() == b.affected_by_join()
    for new in (1, hosts, 2 * hosts):
        assert elastic.remesh_plan(hosts, new, 8, 2) == \
            r_el.remesh_plan(hosts, new, 8, 2)


# -- the drills --------------------------------------------------------------

def _no_backend(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "backend"}


def test_churn_drill_torch_equals_reference_jax():
    kw = dict(hosts=32, events=8, seed=3, spacing=20)
    got = elastic.churn_drill(backend="torch", device="cpu", **kw)
    want = r_el.churn_drill(backend="jax", **kw)
    assert got["backend"] == "torch"
    assert _no_backend(got) == _no_backend(want)
    assert got["joins"] + got["leaves"] == 8 and got["converged"] == 1.0
    assert elastic.churn_drill(backend="numpy", **kw) == \
        r_el.churn_drill(backend="numpy", **kw)
    with pytest.raises(ValueError, match="torch engine"):
        elastic.churn_drill(backend="numpy", wheel_kernels="none", **kw)


def test_decision_latency_profile_torch_equals_reference_jax():
    kw = dict(hosts=32, trials=4, seed=2)
    got = elastic.decision_latency_profile(backend="torch", device="cpu", **kw)
    want = r_el.decision_latency_profile(backend="jax", **kw)
    assert _no_backend(got) == _no_backend(want) and got["converged"] == 1.0


def test_profile_from_a_serve_trace():
    """A trace of the port's server (numpy engine, churn and bursts) gives
    the reference's profile; so does a trace with no settle record."""
    from repro_torch.launch import serve

    ring = dht.Ring.random(96, 32, seed=6)
    votes = (np.random.default_rng(6).random(96) < 0.4).astype(np.int64)
    from repro_torch.engine import make_engine

    server = serve.ThresholdServer(make_engine("numpy", ring, votes, seed=7),
                                   window=6)
    while not server.settled:
        server.pump()
    work = serve.gen_workload(ring, "majority", windows=30, seed=8, rate=24,
                              p_churn=0.3)
    serve.replay_workload(server, work)
    while not server.settled:
        server.pump()
    got = elastic.decision_latency_profile(trace=server.trace)
    assert got == r_el.decision_latency_profile(trace=server.trace)
    assert got["decisions"] > 0
    flush_only = [r for r in server.trace if r["kind"] == "flush"]
    assert elastic.decision_latency_profile(trace=flush_only) == \
        r_el.decision_latency_profile(trace=flush_only)


# -- the suspicion bridge ----------------------------------------------------

def _bridge_run(backend: str, mods):
    """The reference's bridge test (tests/test_faults.py) on one engine:
    every sync's plans and suspects, and the engine's evictions."""
    dht_m, fault_m, make_engine, FaultConfig, kw = mods
    ring = dht_m.Ring.random(16, 10, seed=7)
    votes = (np.arange(16) % 3 == 0).astype(np.int64)
    eng = make_engine(backend, ring, votes, seed=0, faults=FaultConfig(
        suspect_after=10, evict_after=80), **kw)
    v = np.asarray(eng.votes())
    eng.run_until_converged(truth=int(2 * v.sum() > eng.ring.n),
                            max_cycles=5000)
    bridge = fault_m.EngineSuspicionBridge(
        monitor=fault_m.HeartbeatMonitor(timeout_s=40.0),
        policy=fault_m.RestartPolicy(max_restarts=1))
    log = [(bridge.sync(eng), bridge.suspects(eng))]
    victim = int(eng.ring.addrs[5])
    eng.crash(5)
    eng.step(60)
    log.append((bridge.sync(eng), bridge.suspects(eng)))
    while not eng.evictions:
        eng.step(16)
    log.append((bridge.sync(eng), bridge.suspects(eng)))
    log.append(dict(bridge.monitor.last_seen))
    return victim, log, eng.evictions


def _port_mods(device=None):
    from repro_torch.engine import FaultConfig, make_engine

    return (dht, ft, make_engine, FaultConfig,
            {"device": device} if device else {})


def _reference_mods():
    from repro.engine import make_engine
    from repro.engine.base import FaultConfig

    return (r_dht, r_ft, make_engine, FaultConfig, {})


@pytest.mark.parametrize("port,reference", [("torch", "jax"),
                                            ("numpy", "numpy")])
def test_suspicion_bridge_matches_reference(port, reference):
    got = _bridge_run(port, _port_mods("cpu" if port == "torch" else None))
    want = _bridge_run(reference, _reference_mods())
    assert got == want
    victim, log, evictions = got
    assert victim in log[1][1]                  # suspected before eviction
    assert log[2][0] == [(victim, 1.0)]          # one restart, on budget
    assert [a for _, a in evictions] == [victim]


# -- ROADMAP §C3 as a fixed cell ---------------------------------------------

C3 = ("majority", 102055, "crash")


def _port_factory(backend: str):
    """A harness factory (`_diff_harness.replay`) building the port's
    engine from the reference's arguments."""
    from repro_torch.engine import FaultConfig, get_problem, make_engine
    from tests.torch_sharded_ranks import problem_kw

    def build(ring, data, problem, seed, faults=None):
        kw = {"device": "cpu"} if backend == "torch" else {}
        f = None if faults is None else FaultConfig(
            p_drop=faults.p_drop, p_delay=faults.p_delay,
            suspect_after=faults.suspect_after,
            evict_after=faults.evict_after, seed=faults.seed)
        return make_engine(backend, dht.Ring(ring.addrs, ring.d), data,
                           seed=seed, faults=f, problem=get_problem(
                               problem.name, **problem_kw(problem)), **kw)

    return build


def test_c3_cell_each_port_engine_equals_its_reference():
    sched = H.make_schedule(C3[0], C3[1], faults=C3[2])
    ref_np = H.replay(sched, H.numpy_factory)
    ref_jax = H.replay(sched, H.jax_factory)
    port_np = H.replay(sched, _port_factory("numpy"))
    port_torch = H.replay(sched, _port_factory("torch"))
    H.assert_trajectory_parity(ref_np, port_np, "C3 numpy")
    H.assert_trajectory_parity(ref_jax, port_torch, "C3 torch")
    assert (len(port_np["evictions"]), port_np["cycles"]) == (3, 373)
    assert (len(port_torch["evictions"]), port_torch["cycles"]) == (1, 312)
    assert [a for _, a in port_torch["evictions"]] == [343_863_483]
    assert port_np["evict_addrs"] == sorted(
        [476_567_397, 208_887_809, 343_863_483])
