"""The fault plane of `TorchEngine` against the reference engine, on the CPU.

The port's engine runs with ``device="cpu"`` (its kernel wrappers then
take their plain versions) beside ``JaxEngine(kernel="ref",
wheel_kernels="none")`` under an armed fault plane (crashes, seeded
drops and delays, the timeout detector and its evictions):

  * the four `FAULT_GRID` schedules of tests/_diff_harness.py replayed on
    both engines must be trajectory-identical (cycles, messages, the
    wheel-occupancy trace, the eviction timeline, the loss tally, the
    outputs and the data);
  * a crash cell and a drop cell run in per-cycle lockstep: the full
    state is compared (exactly) after every cycle, every eviction sweep
    and every crash/join/leave;
  * the reference's crash guards hold for the port.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.dht import Ring as JRing
from repro.engine.base import FaultConfig as JFaultConfig
from repro.engine.jax_backend import JaxEngine
from repro_torch.core.dht import Ring
from repro_torch.engine import (FaultConfig, TorchEngine, get_problem,
                                make_engine)
from repro_torch.engine.convert import state_to_numpy
from tests import _diff_harness as H


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_problem(problem):
    """The reference problem instance as the port's, by name."""
    kw = {}
    if problem.name == "mean":
        kw = dict(tau=problem.tau, scale=problem.scale)
    elif problem.name == "l2":
        kw = dict(tau=problem.tau, dim=problem.data_width,
                  scale=problem.scale, ndirs=problem.U.shape[0])
    return get_problem(problem.name, **kw)


def _port_faults(faults):
    """The reference `FaultConfig` as the port's, field by field."""
    if faults is None:
        return None
    return FaultConfig(p_drop=faults.p_drop, p_delay=faults.p_delay,
                       suspect_after=faults.suspect_after,
                       evict_after=faults.evict_after, seed=faults.seed)


def torch_factory(ring, data, problem, seed, faults=None):
    return make_engine("torch", Ring(ring.addrs, ring.d), data, seed=seed,
                       device="cpu", problem=_port_problem(problem),
                       faults=_port_faults(faults))


@pytest.mark.parametrize("cell", H.FAULT_GRID,
                         ids=[f"{p}-{s}-{m}" for p, s, m in H.FAULT_GRID])
def test_fault_grid_trajectory_parity(cell):
    """Crash cells evict exactly one peer at the reference's cycle, drop
    cells lose the reference's rows; everything else is identical."""
    sched = H.make_schedule(cell[0], cell[1], faults=cell[2])
    want = H.replay(sched, H.jax_factory)
    got = H.replay(sched, torch_factory)
    H.assert_trajectory_parity(want, got, f"{cell}")
    assert got["lost"] > 0
    if cell[2] == "crash":
        assert len(got["evictions"]) == 1


def _assert_same_state(je, te, where):
    want = {k: np.asarray(v) for k, v in je._st._asdict().items()}
    got = state_to_numpy(te._st)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        if not np.array_equal(g, w):
            raise AssertionError(f"{where}: state field {k!r} differs")


def _lockstep(je, te):
    """Every torch cycle steps the reference one cycle (no sweep), every
    torch eviction sweep runs the reference's; state compared after
    each, and the eviction timelines after each sweep."""
    import jax.numpy as jnp

    cycle, sweep = te._cycle, te._fault_sweep

    def both_cycle():
        cycle()
        je._st = je._steps(je._st, jnp.asarray(1, jnp.int32))
        _assert_same_state(je, te, f"cycle {te.t}")

    def both_sweep():
        sweep()
        je._fault_sweep()
        assert te.evictions == je.evictions
        _assert_same_state(je, te, f"sweep at {te.t}")

    te._cycle, te._fault_sweep = both_cycle, both_sweep


@pytest.mark.parametrize("mode", ["crash", "drop"])
def test_fault_lockstep(mode):
    """Full state equal after every cycle, sweep and event, through a
    crash and its eviction (or a lossy run), a join and a leave, and the
    reconvergence."""
    n = 40
    jring = JRing.random(n, 32, seed=31)
    votes = (np.arange(n) % 3 == 0).astype(np.int64)
    fkw = (dict(suspect_after=10, evict_after=40, seed=5) if mode == "crash"
           else dict(p_drop=0.1, p_delay=0.05, suspect_after=25, seed=6))
    je = JaxEngine(jring, votes, seed=7, kernel="ref", wheel_kernels="none",
                   faults=JFaultConfig(**fkw))
    te = TorchEngine(Ring(jring.addrs, 32), votes, seed=7, device="cpu",
                     faults=FaultConfig(**fkw))
    _assert_same_state(je, te, "after the init storm")
    _lockstep(je, te)
    te.step(30)
    if mode == "crash":
        for eng in (te, je):
            eng.crash(11)
        _assert_same_state(je, te, "after the crash")
    te.step(90)
    if mode == "crash":
        assert len(te.evictions) == 1 and not te.dead_mask().any()
    for op, args in (("join", (12345,)), ("leave", (3,))):
        for eng in (te, je):
            getattr(eng, op)(*args)
        _assert_same_state(je, te, f"after {op}")
    v = te.votes()
    res = te.run_until_converged(truth=int(2 * v.sum() >= v.size),
                                 max_cycles=5000)
    assert res["converged"] == 1.0
    assert te.evictions == je.evictions
    assert te.lost_to_fault == je.lost_to_fault > 0
    np.testing.assert_array_equal(te.last_heard(), je.last_heard())
    assert te.check_conservation() == je.check_conservation()


def _mk(faults=None, n=16):
    ring = Ring.random(n, 10, seed=7)
    votes = (np.arange(n) % 3 == 0).astype(np.int64)
    return make_engine("torch", ring, votes, seed=0, device="cpu",
                       faults=faults)


def test_crash_requires_armed_plane():
    eng = _mk()
    with pytest.raises(RuntimeError):
        eng.crash(0)


def test_crash_guards():
    eng = _mk(FaultConfig(suspect_after=10, evict_after=40))
    with pytest.raises(IndexError):
        eng.crash(99)
    eng.crash(3)
    with pytest.raises(ValueError):  # already dead
        eng.crash(3)
    assert eng.dead_mask()[3] and eng.dead_mask().sum() == 1


def test_crash_schedule_replays_on_both_port_engines():
    """A churn schedule with crashes, a mass join and a range failure
    replays on the armed torch engine and the port's numpy oracle with
    the same membership and dead sets (probe-only detector)."""
    from repro_torch.core.churn import random_schedule

    ring = Ring.random(24, 10, seed=2)
    sched = random_schedule(ring, 10, seed=5, p_leave=0.3, p_crash=0.25,
                            n_min=6, spacing=8, mass_join=3, range_fail=2)
    kinds = [op[0] for op in sched.ops]
    assert kinds.count("crash") >= 2 and kinds.count("join") >= 3
    got = {}
    for backend in ("torch", "numpy"):
        votes = (np.arange(24) % 3 == 0).astype(np.int64)
        kw = {"device": "cpu"} if backend == "torch" else {}
        eng = make_engine(backend, ring, votes, seed=3, faults=FaultConfig(
            suspect_after=20, evict_after=0), **kw)
        sched.apply(eng)
        got[backend] = (eng.ring.n, int(eng.dead_mask().sum()))
    assert got["torch"] == got["numpy"] == (sched.snaps[-1][0].n,
                                            kinds.count("crash"))
