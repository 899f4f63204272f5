"""Alg. 2 churn and the mean/L2 problems on `TorchEngine`, on the CPU.

The port's engine runs with ``device="cpu"`` (its kernel wrappers then
take their plain versions) in lockstep with
``JaxEngine(kernel="ref", wheel_kernels="none")``: the full state is
compared field by field and exactly (tolerance 0) after every cycle and
after every join and leave. Covered here: the two golden jax problem
cells (mean, L2) through all three stages (converge, full-width data
flip, one join + one leave) with their golden cycles, messages and
output/data hashes; joins past the padded tables (`_grow`); churn under
a binding work budget; and a majority engine whose wheel kernels leave
out "threshold", so its event react runs `majority_step`. The majority
golden cells run all three stages in tests/test_torch_engine.py.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from repro.core.churn import random_schedule as r_random_schedule
from repro.core.dht import Ring as JRing
from repro.engine import protocol as RP
from repro.engine.jax_backend import JaxEngine
from repro_torch.core.churn import random_schedule
from repro_torch.core.dht import Ring
from repro_torch.engine import L2Thresh, MeanMonitor, TorchEngine
from repro_torch.engine import protocol as TP
from tests._golden_capture import _problem_data, _problem_instance
from tests.test_torch_engine import (GOLDEN, _assert_same_state, _lockstep,
                                     _votes)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test worker (tiny eager CPU tensors)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(a):
    return hashlib.sha256(np.asarray(a, np.int64).tobytes()).hexdigest()


def _pair(n, seed, data, eng_seed, port_problem=None, ref_problem=None,
          **sizing):
    """(reference engine, port engine) on one ring, in lockstep."""
    jring = JRing.random(n, 32, seed=seed)
    je = JaxEngine(jring, data, seed=eng_seed, kernel="ref",
                   wheel_kernels="none", problem=ref_problem,
                   **{k: v for k, v in sizing.items() if k != "wheel_kernels"})
    te = TorchEngine(Ring(jring.addrs, 32), data, seed=eng_seed,
                     problem=port_problem, device="cpu", **sizing)
    _assert_same_state(je, te, "after the init storm")
    _lockstep(je, te)
    return je, te


def _both(je, te, op, *args, **kw):
    """Apply one membership op to both engines and compare."""
    out = getattr(te, op)(*args, **kw), getattr(je, op)(*args, **kw)
    _assert_same_state(je, te, f"after {op}{args}")
    assert te.n == je.n and np.array_equal(te.ring.addrs, je.ring.addrs)
    return out


def _replay(je, te, sched):
    """A churn schedule on both engines: each op, then its gap in
    lockstep (every cycle compared)."""
    for op, gap in zip(sched.ops, sched.gaps):
        if op[0] == "join":
            _both(je, te, "join", op[1], vote=op[2])
        else:
            _both(je, te, "leave", op[1])
        te.step(int(gap))


@pytest.mark.parametrize("idx", range(2))
def test_golden_problem_cells_lockstep(idx):
    """The golden jax mean / L2 cells: full state equal after every cycle
    and every join/leave through all three stages; stage cycles,
    messages and the output/data hashes are the golden cell's."""
    with open(GOLDEN) as f:
        cell = [c for c in json.load(f)["problems"] if c["cell"][4] == "jax"][idx]
    name, n, ring_seed, eng_seed, _ = cell["cell"]
    port = (MeanMonitor(tau=0.0, scale=256) if name == "mean"
            else L2Thresh(tau=1.0, dim=2))
    ref = _problem_instance(name)
    rng = np.random.default_rng(ring_seed + 200)
    je, te = _pair(n, ring_seed, _problem_data(name, n, rng, 0), eng_seed,
                   port, ref)
    stages = [te.run_until_converged(
        truth=port.global_output(te.data()), max_cycles=20_000)]
    new = _problem_data(name, n, rng, 1)
    te.set_votes(np.arange(n), new)
    je.set_votes(np.arange(n), new)
    _assert_same_state(je, te, "after the data flip")
    stages.append(te.run_until_converged(
        truth=port.global_output(te.data()), max_cycles=20_000))
    free = np.setdiff1d(np.arange(1, 1 << 16, dtype=np.uint64),
                        te.ring.addrs % (1 << 16))
    _both(je, te, "join", int(free[3]), vote=_problem_data(name, 1, rng, 1)[0])
    _both(je, te, "leave", 0)
    truth = port.global_output(te.data())
    assert truth == ref.global_output(je.data())
    stages.append(te.run_until_converged(truth=truth, max_cycles=20_000))
    for got, want in zip(stages, cell["stages"]):
        assert got["converged"] == want["converged"] == 1.0
        assert (got["cycles"], got["messages"]) == (want["cycles"],
                                                    want["messages"])
    assert _sha(te.outputs()) == cell["outputs_sha"]
    assert _sha(te.data()) == cell["data_sha"]
    assert te.dropped == 0
    te.check_conservation()


def test_churn_grow_past_pad_lockstep():
    """Joins past the padded tables re-pad them (`_grow`: new lanes,
    re-laned wheel rows, counters folded into lane 0) exactly as the
    reference does, then the run reconverges in lockstep."""
    n = 24
    rng = np.random.default_rng(5)
    votes = _votes(n, 0.25, rng)
    je, te = _pair(n, 5, votes, 6, pad_to=26)
    assert te.pad == 26 and te.lanes == 2
    assert te.run_until_converged(truth=0, max_cycles=10_000)["converged"] == 1.0
    sched = random_schedule(te.ring, 4, seed=7, p_leave=0.0, spacing=12)
    _replay(je, te, sched)
    assert te.n == n + 4 and te.pad == je.pad == 64 and te.lanes == 8
    v = te.votes()
    res = te.run_until_converged(truth=int(2 * v.sum() >= v.size),
                                 max_cycles=20_000)
    assert res["converged"] == 1.0 and te.dropped == 0
    te.check_conservation()


def test_churn_under_budget_pressure_lockstep():
    """A binding work budget (deferred > 0) with churn: ALERT rows ride
    ahead of data in the drain window, the fence and re-lane run on a
    backlogged wheel, and the state stays the reference's."""
    n = 96
    rng = np.random.default_rng(31)
    je, te = _pair(n, 31, _votes(n, 0.35, rng), 7, work_budget=16)
    assert te.run_until_converged(truth=0, max_cycles=20_000)["converged"] == 1.0
    _replay(je, te, random_schedule(te.ring, 3, seed=32, spacing=20))
    assert te.deferred > 0
    v = te.votes()
    res = te.run_until_converged(truth=int(2 * v.sum() >= v.size),
                                 max_cycles=30_000)
    assert res["converged"] == 1.0 and te.dropped == 0
    te.check_conservation()


def test_majority_step_route_with_churn_lockstep():
    """wheel_kernels without "threshold": a majority engine runs its
    event react (the init storm and data changes) through
    `majority_step`, bit-identical to the reference."""
    n = 64
    rng = np.random.default_rng(41)
    je, te = _pair(n, 41, _votes(n, 0.4, rng), 42,
                   wheel_kernels=("dedup", "enqueue", "descent"))
    assert te._majority_react
    te.step(20)
    chg = np.arange(0, n, 5)
    te.set_votes(chg, np.ones(chg.size, np.int64))
    je.set_votes(chg, np.ones(chg.size, np.int64))
    _assert_same_state(je, te, "after set_votes")
    _replay(je, te, random_schedule(te.ring, 2, seed=43, spacing=20))
    te.check_conservation()


@pytest.mark.parametrize("seed", [3, 17])
def test_random_schedule_is_the_reference_schedule(seed):
    """The port's copy draws the reference's ops, gaps and Alg. 2
    snapshots for the same seed."""
    ring = JRing.random(40, 32, seed=seed)
    kw = dict(p_leave=0.5, mean_gap=12.0, mass_join=3)
    want = r_random_schedule(ring, 12, seed, **kw)
    got = random_schedule(Ring(ring.addrs, 32), 12, seed, **kw)
    assert got.ops == want.ops
    np.testing.assert_array_equal(got.gaps, want.gaps)
    for (rg, *tg), (rw, *tw) in zip(got.snaps, want.snaps):
        assert tg == tw and np.array_equal(rg.addrs, rw.addrs)


@pytest.mark.parametrize("d", [32, 16])
def test_change_positions_and_alert_plan_match_reference(d):
    """Alg. 2 change positions over every (a_im2, a_im1, a_i) triple of a
    real ring (the wrapped root segment included) and its ALERT plan."""
    ring = JRing.random(200, d, seed=d)
    a = ring.addrs.astype(np.uint32)
    trip = [np.roll(a, 1), a, np.roll(a, -1)]
    want = RP.change_positions(np, *trip, d)
    got = TP.change_positions(*[torch.from_numpy(t.astype(np.int64))
                                for t in trip], d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    wp, wd = RP.alert_plan(np, want[0][7], want[1][7])
    gp, gd = TP.alert_plan(got[0][7], got[1][7])
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp, np.int64))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
