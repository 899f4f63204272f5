"""The port's host numpy layer and its numpy oracle, against the reference.

  * each host copy — the new `core.addressing` functions, the numpy forms
    of `engine.protocol` (`suspicion_rules` included) and of the problems,
    `core.routing`, `core.notify` and the eviction helpers of
    `core.majority` — equals the reference's function exactly on seeded
    grids;
  * the port's `NumpyEngine` reproduces the golden numpy cells of
    tests/golden_majority.json (stage cycles and messages, output and
    data/vote hashes), run through tests/_golden_capture.py with the
    port's engine and problems in place of the reference's;
  * on the `FAULT_GRID` crash and drop schedules it is
    trajectory-identical to the reference `NumpyEngine` (same host RNG
    draws), and state-identical to the port's `TorchEngine` (the
    harness's numpy-vs-device level: other delays, same evictions,
    outputs and data).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import repro.core.addressing as JA
import repro.core.majority as JM
import repro.core.notify as JN
import repro.core.routing as JR
import repro.engine.problems as JP
import repro.engine.protocol as JPR
import repro_torch.core.addressing as TA
import repro_torch.core.majority as TM
import repro_torch.core.notify as TN
import repro_torch.core.routing as TR
import repro_torch.engine.problems as TP
import repro_torch.engine.protocol as TPR
from repro.core.dht import Ring as JRing
from repro_torch.core.dht import Ring
from repro_torch.engine import make_engine
from tests import _diff_harness as H
from tests import _golden_capture as GC
from tests.test_torch_faults import _port_faults, _port_problem, torch_factory

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_majority.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    """Equal values, dtypes and shapes, through tuples and dataclasses."""
    if isinstance(want, tuple) and not hasattr(want, "_fields"):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if hasattr(want, "_fields"):  # NamedTuple
        for f in want._fields:
            _same(getattr(got, f), getattr(want, f))
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _rings():
    return [(JRing.random(n, d, seed=s), d) for n, d, s in
            ((40, 32, 1), (64, 16, 2), (9, 10, 3))]


# ---------------------------------------------------------------------------
# the host copies, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d", [(np.uint64, 20), (np.uint32, 32)])
def test_addressing_copies(dtype, d):
    rng = np.random.default_rng(d)
    x = rng.integers(0, 1 << d, 4096, dtype=np.uint64).astype(dtype)
    y = rng.integers(0, 1 << d, 4096, dtype=np.uint64).astype(dtype)
    x[:8] = 0
    _same(TA.depth(x, d), JA.depth(x, d))
    _same(TA.span(x), JA.span(x))
    _same(TA.in_ccw_subtree(x, y, d), JA.in_ccw_subtree(x, y, d))
    for v in (TA.CW, TA.CCW):
        _same(TA.descendant(x, v, d), JA.descendant(x, v, d))


def test_protocol_numpy_forms():
    rng = np.random.default_rng(5)
    for jring, d in _rings():
        dt = jring.addrs.dtype
        pos = jring.positions()
        n = jring.n
        peers = np.repeat(np.arange(n), 3)
        dirs = np.tile(np.arange(3), n)
        args = (pos[peers], dirs, jring.addrs[peers], jring.prev[peers], d)
        _same(TPR.send_fields(*args), JPR.send_fields(np, *args))
        m = 512
        own = rng.integers(0, n, m)
        kw = dict(origin=pos[rng.integers(0, n, m)],
                  dest=rng.integers(0, 1 << d, m, dtype=np.uint64).astype(dt),
                  edge=jring.addrs[rng.integers(0, n, m)],
                  has_edge=rng.random(m) < 0.7,
                  network_entry=rng.random(m) < 0.8, pos_i=pos[own],
                  a_prev=jring.prev[own], a_self=jring.addrs[own],
                  self_seg=rng.random(m) < 0.3, max_addr=jring.addrs[-1], d=d)
        for repair in (True, False):
            _same(TPR.deliver_rules(repair=repair, **kw),
                  JPR.deliver_rules(np, repair=repair, **kw))
        a = [jring.addrs[(i + k) % n] for i, k in ((3, -1), (3, 0), (3, 1))]
        _same(TPR.change_positions(*a, d), JPR.change_positions(np, *a, d))
        pf, pv = JPR.change_positions(np, *a, d)
        _same(TPR.alert_plan(pf, pv), JPR.alert_plan(np, pf, pv))
    heard = rng.integers(-(1 << 30), 200, 3000).astype(np.int32)
    probed = rng.integers(0, 200, 3000).astype(np.int32)
    for ev in (0, 60):
        _same(TPR.suspicion_rules(heard, probed, 210, 25, ev),
              JPR.suspicion_rules(np, heard, probed, 210, 25, ev))


PROBLEM_ARGS = [("majority", {}), ("mean", dict(tau=0.3)),
                ("l2", dict(tau=1.0, dim=2)), ("l2", dict(tau=0.7, dim=9))]


@pytest.mark.parametrize("name,kw", PROBLEM_ARGS,
                         ids=[f"{n}{k.get('dim', '')}" for n, k in PROBLEM_ARGS])
def test_problem_numpy_forms(name, kw):
    """init_state, margin, test, global_output and the Alg. 3 rules on
    numpy planes, the argmax ties of L2 included."""
    tp, jp = TP.get_problem(name, **kw), JP.get_problem(name, **kw)
    rng = np.random.default_rng(len(name))
    n, dw, pw = 600, jp.data_width, jp.payload_width
    raw = (rng.integers(0, 2, n) if name == "majority"
           else rng.normal(0.2, 1.0, (n, dw) if name == "l2" else n))
    data = jp.init_state(raw)
    _same(tp.init_state(raw), data)
    assert tp.global_output(data) == jp.global_output(data)
    xin = rng.integers(-300, 300, (n, 3, pw)).astype(np.int64)
    xout = rng.integers(-300, 300, (n, 3, pw)).astype(np.int64)
    xin[: n // 4, :, :-1] = 0
    data[: n // 4] = 0  # zero vector sums: every L2 half-space ties
    _same(tp.margin(np, xin), jp.margin(np, xin))
    _same(tp.test(np, xin + xout, xin.sum(1)), jp.test(np, xin + xout,
                                                       xin.sum(1)))
    _same(TPR.threshold_rules(tp, xin, xout, data),
          JPR.threshold_rules(jp, np, xin, xout, data))
    if name == "majority":
        planes = (xin[..., 0], xin[..., 1], xout[..., 0], xout[..., 1],
                  data[:, 0])
        _same(TPR.majority_rules(*planes), JPR.majority_rules(*planes))


def test_routing_copies():
    for jring, d in _rings():
        ring = Ring(jring.addrs, d)
        for i in range(jring.n):
            for v in range(3):
                want = JR.route(jring, i, v)
                got = TR.route(ring, i, v)
                assert got[0] == want[0]
                assert [(h.dest, h.peer) for h in got[1]] == [
                    (h.dest, h.peer) for h in want[1]]
        peers = np.repeat(np.arange(jring.n), 3)
        dirs = np.tile(np.arange(3), jring.n)
        sent = JR.send_batch(jring, peers, dirs)
        _same(TR.send_batch(ring, peers, dirs), sent)
        ok = sent[0]
        args = tuple(a[ok] for a in sent[1:])
        _same(TR.step_batch(ring, *args), JR.step_batch(jring, *args))


def test_notify_copies():
    for jring, d in _rings():
        ring = Ring(jring.addrs, d)
        free = int(np.setdiff1d(np.arange(1, 4096, dtype=np.uint64),
                                jring.addrs)[5])
        jr_after, k = jring.join(free)
        tr_after, tk = ring.join(free)
        cases = [(JN.join_event(jr_after, k), TN.join_event(tr_after, tk))]
        for idx in (0, jring.n // 2, jring.n - 1):
            cases.append((JN.leave_event(jring.leave(idx), jring, idx),
                          TN.leave_event(ring.leave(idx), ring, idx)))
        for want, got in cases:
            assert (got.notifs, got.deliveries, got.pos_fix, got.pos_var) == (
                want.notifs, want.deliveries, want.pos_fix, want.pos_var)
            assert [a.__dict__ for a in got.alerts] == [
                a.__dict__ for a in want.alerts]
            assert [None if t is None else [(h.dest, h.peer) for h in t]
                    for t in got.traces] == [
                None if t is None else [(h.dest, h.peer) for h in t]
                for t in want.traces]


def test_eviction_helper_copies():
    """monitored_links, resolve_far, accuse, elect_eviction and
    eviction_grace on rings with dead peers and random stamps."""
    rng = np.random.default_rng(9)
    for jring, d in _rings():
        ring = Ring(jring.addrs, d)
        pos = jring.positions()
        n = jring.n
        dead = rng.random(n) < 0.15
        want = JM.monitored_links(jring, pos, dead)
        _same(TM.monitored_links(ring, pos, dead), want)
        peers, dirs, mon = want
        _same(TM.resolve_far(ring, pos, peers, dirs),
              JM.resolve_far(jring, pos, peers, dirs))
        for trial in range(4):
            heard = rng.integers(0, 300, 3 * n).astype(np.int32)
            heard[rng.random(3 * n) < 0.3] = 0
            stamps = heard.astype(np.int64)
            last = rng.integers(0, 300, n)
            fresh = rng.random(n) < 0.5
            _same(TM.accuse(ring, pos, peers, dirs, stamps, last, fresh, 12),
                  JM.accuse(jring, pos, peers, dirs, stamps, last, fresh, 12))
            _, evict = JPR.suspicion_rules(np, heard, heard, 300, 25, 150)
            margin = JM.eviction_grace(n, 25)
            assert TM.eviction_grace(n, 25) == margin
            assert TM.elect_eviction(ring, pos, peers, dirs, mon, evict,
                                     heard, margin) == JM.elect_eviction(
                jring, pos, peers, dirs, mon, evict, heard, margin)


# ---------------------------------------------------------------------------
# the numpy oracle engine
# ---------------------------------------------------------------------------

def _golden(key, backend):
    with open(GOLDEN) as f:
        cells = json.load(f)[key]
    return [c for c in cells if c["cell"][4] == backend]


def _port_golden(monkeypatch):
    """Point the golden-capture script at the port's engine and problems."""
    monkeypatch.setattr(GC, "make_engine", make_engine)
    monkeypatch.setattr(GC, "Ring", Ring)
    monkeypatch.setattr(GC, "MeanMonitor", TP.MeanMonitor)
    monkeypatch.setattr(GC, "L2Thresh", TP.L2Thresh)


@pytest.mark.parametrize("idx", range(3))
def test_numpy_engine_golden_majority(idx, monkeypatch):
    cell = _golden("cells", "numpy")[idx]
    _port_golden(monkeypatch)
    assert GC.run_cell(*cell["cell"][:5], None) == dict(cell, cell=[
        *cell["cell"][:5], ""])


@pytest.mark.parametrize("idx", range(2))
def test_numpy_engine_golden_problems(idx, monkeypatch):
    cell = _golden("problems", "numpy")[idx]
    _port_golden(monkeypatch)
    assert GC.run_problem_cell(cell["cell"]) == cell


def _port_numpy_factory(ring, data, problem, seed, faults=None):
    return make_engine("numpy", Ring(ring.addrs, ring.d), data, seed=seed,
                       problem=_port_problem(problem),
                       faults=_port_faults(faults))


@pytest.mark.parametrize("cell", [("majority", 404, "crash"),
                                  ("l2", 707, "drop")],
                         ids=["majority-404-crash", "l2-707-drop"])
def test_numpy_engine_fault_cells(cell):
    sched = H.make_schedule(*cell[:2], faults=cell[2])
    got = H.replay(sched, _port_numpy_factory)
    H.assert_trajectory_parity(H.replay(sched, H.numpy_factory), got,
                               f"{cell} numpy")
    H.assert_state_parity(got, H.replay(sched, torch_factory),
                          f"{cell} numpy vs torch")
    assert got["lost"] > 0
