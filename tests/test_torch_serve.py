"""The port's serve layer (`repro_torch.launch.serve`) on the CPU.

The reference's serve cells (`tests/_diff_harness.py` SERVE_GRID: a
majority, a mean and an L2 workload with churn, coalesced submits and
subscriber flips) are replayed through the port's `ThresholdServer`:

  * on the port's `NumpyEngine`, against the reference's server on its
    own `NumpyEngine`: the transition stream, outputs, data, counters and
    the whole `stats()` equal;
  * on a CPU `TorchEngine`, against the same: outputs, data, the decision
    and every counter that does not depend on the delay RNG (the device
    engines draw delays from hashes, the numpy ones from a host RNG); and
    on the majority cell against the reference's server on its
    `JaxEngine` (the same delay family): the transition stream, cycles,
    messages and `stats()` equal. Conservation holds after every flush.

Plus the host pieces as `tests/test_serve.py` has them: the coalescing
counters, stale-update drop, subscribe/unsubscribe, the rejection of
batched engines, and the demo CLI.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _diff_harness import SERVE_GRID, make_serve_schedule  # noqa: E402

import repro.launch.serve as ref_serve  # noqa: E402
from repro.core.dht import Ring as JRing  # noqa: E402
from repro.engine import get_problem as jax_get_problem  # noqa: E402
from repro.engine import make_engine as jax_make_engine  # noqa: E402
from repro_torch.core.dht import Ring  # noqa: E402
from repro_torch.engine import get_problem, make_engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

RNG_FREE = ("submitted", "coalesced", "applied", "stale_dropped", "flushes",
            "windows", "coalescing_ratio", "backlog", "dropped")
PROBLEM_KW = {"majority": {}, "mean": {"tau": 0.0},
              "l2": {"tau": 1.0, "dim": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch on tiny tensors is op-overhead bound."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay(sched, mod, ring_cls, build):
    """Drive one engine through the schedule via `mod`'s serve API, check
    conservation after every flush, then converge to the truth."""
    ring = ring_cls.random(sched["n"], sched["d"], seed=sched["ring_seed"])
    eng = build(ring, sched["data"], sched["eng_seed"])
    server = mod.ThresholdServer(eng,
                                 window=sched["workload"]["window_cycles"])
    transitions = []
    server.subscribe(lambda tr: transitions.append(
        (tr.t, tuple(sorted(tr.peers)), tr.output)))

    def after(_i):
        if hasattr(eng, "check_conservation"):
            eng.check_conservation()

    mod.replay_workload(server, sched["workload"], after_pump=after)
    stats = server.stats()
    truth = eng.problem.global_output(np.asarray(eng.data()))
    assert server.truth == truth
    res = eng.run_until_converged(truth, max_cycles=40_000)
    assert res["converged"] == 1.0
    return {"outputs": np.asarray(eng.outputs(), np.int64),
            "data": np.asarray(eng.data(), np.int64), "truth": truth,
            "cycles": int(eng.t), "messages": int(eng.messages_sent),
            "stats": stats, "transitions": transitions}


def _reference(sched, backend):
    prob = jax_get_problem(sched["problem"], **PROBLEM_KW[sched["problem"]])
    kw = {"kernel": "ref", "wheel_kernels": "none"} if backend == "jax" else {}
    return _replay(sched, ref_serve, JRing, lambda r, d, s: jax_make_engine(
        backend, r, d, seed=s, problem=prob, **kw))


def _port(sched, backend):
    prob = get_problem(sched["problem"], **PROBLEM_KW[sched["problem"]])
    kw = {"device": "cpu"} if backend == "torch" else {}
    return _replay(sched, serve, Ring, lambda r, d, s: make_engine(
        backend, r, d, seed=s, problem=prob, **kw))


def _same_end(got, want, ctx):
    np.testing.assert_array_equal(got["outputs"], want["outputs"], ctx)
    np.testing.assert_array_equal(got["data"], want["data"], ctx)
    assert got["truth"] == want["truth"], ctx
    assert got["stats"]["dropped"] == 0, ctx


@pytest.mark.parametrize("problem,seed", SERVE_GRID)
def test_serve_cell_matches_reference(problem, seed):
    sched = make_serve_schedule(problem, seed)
    # the port's generator draws the reference's workloads
    ring = Ring.random(sched["n"], sched["d"], seed=sched["ring_seed"])
    jring = JRing.random(sched["n"], sched["d"], seed=sched["ring_seed"])
    kw = dict(windows=14, seed=seed, rate=6.5, p_churn=0.35,
              window_cycles=5, p_flip_sub=0.25)
    assert serve.gen_workload(ring, problem, **kw) == ref_serve.gen_workload(
        jring, problem, **kw)
    ref = _reference(sched, "numpy")
    port_np = _port(sched, "numpy")
    _same_end(port_np, ref, f"{problem} numpy")
    for k in ("cycles", "messages", "stats", "transitions"):
        assert port_np[k] == ref[k], (problem, k)
    port_t = _port(sched, "torch")
    _same_end(port_t, ref, f"{problem} torch")
    assert {k: port_t["stats"][k] for k in RNG_FREE} == {
        k: ref["stats"][k] for k in RNG_FREE}
    assert port_t["transitions"], problem


def test_serve_torch_matches_reference_jax_majority():
    """The device family: transitions, cycles, messages and every counter
    equal the reference's server on its JaxEngine."""
    sched = make_serve_schedule(*SERVE_GRID[0])
    ref = _reference(sched, "jax")
    port = _port(sched, "torch")
    _same_end(port, ref, "majority torch vs jax")
    for k in ("cycles", "messages", "stats", "transitions"):
        assert port[k] == ref[k], k


def test_coalescing_counters():
    ring = serve.IngestionRing()
    ring.submit(5, 1)
    ring.submit(9, 0)
    ring.submit(5, 0)   # overwrites
    ring.submit(5, 1)   # overwrites again
    assert ring.submitted == 4 and ring.coalesced == 2
    assert ring.pending == 2
    assert ring.drain() == [(5, 1), (9, 0)]  # ascending addr, final values
    assert ring.pending == 0 and ring.flushed == 2
    assert ring.drain() == []


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_stale_updates_dropped_not_applied(backend):
    ring = Ring.random(24, 32, seed=3)
    votes = np.random.default_rng(3).integers(0, 2, 24)
    eng = make_engine(backend, ring, votes, seed=4,
                      **({"device": "cpu"} if backend == "torch" else {}))
    server = serve.ThresholdServer(eng, window=4)
    dead_addr = 123456789  # not on the ring
    assert dead_addr not in set(int(a) for a in ring.addrs)
    server.submit(dead_addr, 1)
    server.submit(int(ring.addrs[0]), 1)
    server.pump()
    st = server.stats()
    assert st["stale_dropped"] == 1 and st["applied"] == 1


def test_notifier_subscribe_unsubscribe():
    n = serve.DecisionNotifier()
    got = []
    sid = n.subscribe(got.append)
    out = n.publish(3, np.asarray([10, 20]), np.asarray([1, 0]))
    assert len(out) == 2 and {tr.output for tr in out} == {0, 1}
    n.unsubscribe(sid)
    n.publish(4, np.asarray([10, 20]), np.asarray([0, 0]))
    assert len(got) == 2  # nothing delivered after unsubscribe
    assert n.publish(5, np.asarray([10]), np.asarray([0])) == []
    n.publish(6, np.asarray([]), np.asarray([]))
    out = n.publish(7, np.asarray([10]), np.asarray([0]))
    assert len(out) == 1 and out[0].peers == frozenset({10})


def test_server_rejects_batched_engines():
    ring = Ring.random(16, 32, seed=1)
    votes = np.zeros((2, 16), np.int64)
    for backend in ("numpy", "torch"):
        bat = make_engine(backend, ring, votes, batch=2,
                          **({"device": "cpu"} if backend == "torch" else {}))
        with pytest.raises(TypeError):
            serve.ThresholdServer(bat)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_serve_cli_replays_a_workload(backend, capsys):
    rec = serve.main(["--backend", backend, "--device", "cpu", "--n", "64",
                      "--windows", "6", "--rate", "12"])
    assert rec["dropped"] == 0 and rec["backlog"] == 0
    assert rec["submitted"] == rec["coalesced"] + rec["applied"] \
        + rec["stale_dropped"]
    assert "[serve] updates_per_sec" in capsys.readouterr().out
