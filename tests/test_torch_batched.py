"""The port's batched trials (`engine.batched`) on the CPU.

`make_engine("torch", ..., batch=B, device="cpu")` runs B trials on one
trial axis (the kernel wrappers take their plain versions on the CPU).
Held, exactly (tolerance 0):

  * against the reference's golden `batched` cell (cycles, messages,
    outputs hash);
  * against the reference's vmapped ``BatchedJaxEngine(kernel="ref")``,
    full state per trial after 50 cycles on three different rings;
  * against B serial port `TorchEngine`s, trial for trial in full state,
    for majority, mean and L2 through converge -> a ragged `set_votes`
    -> converge again (the trials then at different t), with
    ``stable_for=2`` and a `max_cycles` that stops one trial unconverged;
  * `BatchedNumpyEngine` against the reference's;
  * the plain `descent_reference` / `stage_rows_reference` with per-trial
    arguments against the JAX reference functions run per trial.
"""
from __future__ import annotations

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dht import Ring as JRing
from repro.engine import make_engine as jax_make_engine
from repro.kernels.wheel.descent import descent_reference as r_descent
from repro.kernels.wheel.enqueue import stage_rows_reference as r_stage
from repro_torch.core import addressing as A
from repro_torch.core.dht import Ring
from repro_torch.engine import make_engine
from repro_torch.engine.convert import (state_to_numpy, trials_from_numpy,
                                        trials_to_numpy)
from repro_torch.kernels.wheel import descent_reference, stage_rows_reference
from repro_torch.kernels.wheel._common import in_segment

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_majority.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch on tiny tensors is op-overhead bound."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _votes(n, mu, rng):
    v = np.zeros(n, np.int64)
    v[rng.choice(n, int(round(n * mu)), replace=False)] = 1
    return v


def _sha(a):
    return hashlib.sha256(np.asarray(a, np.int64).tobytes()).hexdigest()


def _assert_same(got: dict, want: dict, where: str) -> None:
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        if not np.array_equal(g, w):
            raise AssertionError(f"{where}: state field {k!r} differs")


def test_golden_batched_cell():
    g = json.load(open(GOLDEN))["batched"]
    n, mus, ring_seed, eng_seed = g["cell"]
    rng = np.random.default_rng(ring_seed + 100)
    ring = Ring.random(n, 32, seed=ring_seed)
    votes = np.stack([_votes(n, mu, rng) for mu in mus])
    truths = (2 * votes.sum(1) >= n).astype(np.int64)
    eng = make_engine("torch", ring, votes, seed=eng_seed,
                      batch=votes.shape[0], device="cpu")
    res = eng.run_until_converged(truths)
    for got, want in zip(res, g["results"]):
        assert int(got["cycles"]) == want["cycles"]
        assert int(got["messages"]) == want["messages"]
        assert got["converged"] == want["converged"]
    assert _sha(eng.outputs()) == g["outputs_sha"]
    assert (eng.dropped == 0).all()


def test_batched_state_matches_reference_vmapped():
    """Three different rings, 50 cycles: each trial's full state equals
    the reference's vmapped state of that trial."""
    B, n = 3, 96
    rng = np.random.default_rng(5)
    seeds = [20 + b for b in range(B)]
    votes = np.stack([_votes(n, 0.4, rng) for _ in range(B)])
    jb = jax_make_engine("jax", [JRing.random(n, 32, seed=s) for s in seeds],
                         votes, seed=30, batch=B, kernel="ref",
                         wheel_kernels="none")
    tb = make_engine("torch", [Ring.random(n, 32, seed=s) for s in seeds],
                     votes, seed=30, batch=B, device="cpu")
    jb.step(50)
    tb.step(50)
    got = trials_to_numpy(tb._eng._st, B)
    for b in range(B):
        want = {k: np.asarray(v[b]) for k, v in jb._st._asdict().items()}
        _assert_same(got[b], want, f"trial {b}")
    np.testing.assert_array_equal(tb.messages_sent, jb.messages_sent)
    np.testing.assert_array_equal(tb.t, jb.t)
    np.testing.assert_array_equal(tb.outputs(), jb.outputs())
    # the per-trial conversion round-trips
    back = trials_to_numpy(trials_from_numpy(got), B)
    for b in range(B):
        _assert_same(back[b], got[b], f"round trip {b}")


def _problem_case(name, n, rng):
    """(kw, data (B, n[, D]), flip values (B, k[, D]))."""
    if name == "majority":
        data = np.stack([_votes(n, mu, rng) for mu in (0.3, 0.45, 0.6)])
        flip = np.ones((3, 40), np.int64)
        flip[2] = 0  # trial 2's truth turns
        return {}, data, flip
    if name == "mean":
        data = rng.normal([[0.5], [0.2], [-0.2]], 1.0, (3, n))
        return {"problem": "mean"}, data, np.full((3, 40), 3.0)
    data = rng.normal(0.7, 1.0, (3, n, 2))
    return {"problem": "l2"}, data, np.full((3, 40, 2), -2.0)


# max2 lies between the second run's fastest and slowest trial
@pytest.mark.parametrize("name,max2", [("majority", 75), ("mean", 20),
                                       ("l2", 15)])
def test_batched_matches_serial_engines(name, max2):
    """B = 3 trials on one trial axis vs 3 serial engines, full state per
    trial after each stage; the second run leaves the trials at
    different t (a per-lane slot gather) and stops one unconverged."""
    B, n = 3, 128
    rng = np.random.default_rng(7)
    rings = [Ring.random(n, 32, seed=40 + b) for b in range(B)]
    kw, data, flip = _problem_case(name, n, rng)
    kw["capacity_per_peer"] = 8
    bat = make_engine("torch", rings, data, seed=50, batch=B, device="cpu",
                      **kw)
    ser = [make_engine("torch", rings[b], data[b], seed=50 + b,
                       device="cpu", **kw) for b in range(B)]

    def same(where):
        got = trials_to_numpy(bat._eng._st, B)
        for b in range(B):
            _assert_same(got[b], state_to_numpy(ser[b]._st),
                         f"{name} {where}, trial {b}")

    same("init")
    truths = [e.problem.global_output(e.data()) for e in ser]
    res = bat.run_until_converged(truths, stable_for=2)
    for b in range(B):
        assert ser[b].run_until_converged(truths[b], stable_for=2) == res[b]
    assert all(r["converged"] == 1.0 for r in res)
    same("first convergence")
    t1 = bat.t
    assert len(set(t1.tolist())) == B  # the trials stopped apart

    # ragged flip: trial 0 three peers, trial 1 none (it still reacts:
    # the event counter moves in every trial), trial 2 forty
    idx = np.full((B, 40), -1)
    idx[0, :3] = [1, 2, 3]
    idx[2] = np.arange(40) * 3
    bat.set_votes(idx, flip)
    for b in range(B):
        keep = idx[b] >= 0
        ser[b].set_votes(idx[b][keep], flip[b][keep])
    same("ragged set_votes")
    truths = [e.problem.global_output(e.data()) for e in ser]
    res = bat.run_until_converged(truths, max_cycles=max2, stable_for=2)
    for b in range(B):
        assert ser[b].run_until_converged(truths[b], max_cycles=max2,
                                          stable_for=2) == res[b]
    assert [r["converged"] for r in res].count(0.0) == 1, res
    same("second run")
    bat.step(5)
    for e in ser:
        e.step(5)
    same("step(5)")
    np.testing.assert_array_equal(
        bat.outputs(), np.stack([e.outputs() for e in ser]))
    np.testing.assert_array_equal(
        bat.data(), np.stack([e.data() for e in ser]))
    for b, c in enumerate(bat.check_conservation()):
        assert c == {k: v for k, v in ser[b].check_conservation().items()
                     if k != "lost_to_fault"}
    assert (bat.dropped == 0).all()


def test_batched_api_guards():
    ring = Ring.random(32, 32, seed=7)
    votes = np.zeros((2, 32), np.int64)
    with pytest.raises(ValueError):  # votes must be (B, n)
        make_engine("torch", ring, votes[0], batch=2, device="cpu")
    with pytest.raises(ValueError):  # mismatched ring count
        from repro_torch.engine.batched import BatchedTorchEngine

        BatchedTorchEngine([ring], votes, device="cpu")
    with pytest.raises(ValueError):  # mismatched (n, d)
        make_engine("torch", [ring, Ring.random(16, 32, seed=8)], votes,
                    batch=2, device="cpu")
    with pytest.raises(ValueError):  # seed count
        make_engine("torch", ring, votes, seed=[1, 2, 3], batch=2,
                    device="cpu")
    from repro_torch.engine import FaultConfig

    for backend in ("torch", "numpy"):
        with pytest.raises(NotImplementedError):
            make_engine(backend, ring, votes, batch=2, device="cpu",
                        faults=FaultConfig(suspect_after=25))


@pytest.mark.parametrize("call", ["t", "step", "set_votes", "join", "leave",
                                  "crash", "run_until_converged", "outputs",
                                  "data", "check_conservation"])
def test_trial_axis_refuses_single_trial_calls(call):
    """A TorchEngine with a trial axis refuses the single-trial entry
    points (their host mirrors hold one trial) and leaves its state as
    it was."""
    from repro_torch.engine.convert import trials_to_numpy

    ring = Ring.random(32, 32, seed=7)
    bat = make_engine("torch", ring, np.ones((2, 32), np.int64), batch=2,
                      device="cpu")
    e = bat._eng
    before = trials_to_numpy(e._st, 2)
    args = {"set_votes": ([0], [1]), "join": (5,), "leave": (0,),
            "crash": (0,), "run_until_converged": (1,)}.get(call, ())
    with pytest.raises(NotImplementedError):
        attr = getattr(e, call)
        if callable(attr):
            attr(*args)
    for b, (sa, sb) in enumerate(zip(trials_to_numpy(e._st, 2), before)):
        _assert_same(sa, sb, f"trial {b} after {call}")


def test_batched_numpy_matches_reference():
    B, n = 2, 96
    rng = np.random.default_rng(6)
    votes = np.stack([_votes(n, 0.3, rng) for _ in range(B)])
    ref = jax_make_engine("numpy", JRing.random(n, 32, seed=6), votes,
                          seed=40, batch=B)
    port = make_engine("numpy", Ring.random(n, 32, seed=6), votes, seed=40,
                       batch=B)
    assert port.run_until_converged(0) == ref.run_until_converged(0)
    idx = np.full((B, 3), -1)
    idx[0, :2] = [1, 2]
    idx[1, :1] = [5]
    val = np.ones((B, 3), np.int64)
    for e in (ref, port):
        e.set_votes(idx, val)
        e.step(40)
    np.testing.assert_array_equal(port.votes(), ref.votes())
    np.testing.assert_array_equal(port.outputs(), ref.outputs())
    np.testing.assert_array_equal(port.t, ref.t)
    np.testing.assert_array_equal(port.messages_sent, ref.messages_sent)


def test_stage_rows_per_trial_matches_reference_per_trial():
    """(B, 10) perms and (B,) times over B trial-major blocks, one of them
    near the 32-bit wrap, against the reference run block by block."""
    B, m, roww = 3, 200, 8
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 2**32, (B * m, roww), dtype=np.uint64).astype(
        np.uint32)
    alert = rng.random(B * m) < 0.15
    ordinal = (np.cumsum(rng.random(B * m) < 0.6) - 1).astype(np.int64)
    perm = np.stack([rng.permutation(10) + 1 for _ in range(B)]).astype(
        np.int32)
    t = np.asarray([97, 5, 2**31 - 3], np.int32)
    got = stage_rows_reference(
        torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(alert),
        torch.from_numpy(ordinal), torch.from_numpy(perm),
        torch.from_numpy(t), roww - 1).numpy()
    for b in range(B):
        sl = slice(b * m, (b + 1) * m)
        want = r_stage(jnp.asarray(rows[sl]), jnp.asarray(alert[sl]),
                       jnp.asarray(ordinal[sl].astype(np.int32)),
                       jnp.asarray(perm[b]), jnp.asarray(t[b]), roww - 1)
        np.testing.assert_array_equal(got[sl], np.asarray(want).astype(
            np.int64), err_msg=f"trial {b}")
    # one trial (the single engine's call): the first block alone
    one = stage_rows_reference(
        torch.from_numpy(rows[:m].astype(np.int64)),
        torch.from_numpy(alert[:m]), torch.from_numpy(ordinal[:m]),
        torch.from_numpy(perm[:1]), torch.from_numpy(t[:1]), roww - 1).numpy()
    np.testing.assert_array_equal(one, got[:m])


def test_descent_per_trial_matches_reference_per_trial():
    """Three trials on three rings, each block of rows with its own ring
    maximum, against the reference run block by block."""
    B, m, n, d = 3, 150, 64, 16
    rng = np.random.default_rng(12)
    blocks, maxes = [], []
    for b in range(B):
        addrs = A.random_ring(n, d, seed=b + 1).astype(np.int64)
        prev = np.roll(addrs, 1)
        pos = A.position_from_segment(torch.from_numpy(prev),
                                      torch.from_numpy(addrs), d).numpy()
        dest = rng.integers(0, 2**d, m).astype(np.int64)
        origin = addrs[rng.integers(0, n, m)]
        own = np.searchsorted(addrs, dest, side="left") % n
        blocks.append([origin, dest, rng.integers(0, 2**d, m),
                       rng.random(m) < 0.7, rng.random(m) < 0.8,
                       rng.random(m) < 0.5, pos[own], prev[own],
                       addrs[own]])
        maxes.append(addrs[-1])
    cols = [torch.from_numpy(np.concatenate(c)) for c in zip(*blocks)]
    cols.append(in_segment(cols[0], cols[7], cols[8]))
    got = descent_reference(*cols, torch.tensor(maxes, dtype=torch.int64), d)
    for b in range(B):
        sl = slice(b * m, (b + 1) * m)
        args = [jnp.asarray(c[sl].numpy().astype(
            np.uint32 if c.dtype == torch.int64 else bool)) for c in cols]
        want = r_descent(*args, jnp.asarray(np.uint32(maxes[b])), d=d)
        for g, w, name in zip(got, want, ("acc", "drop", "o_dest", "o_edge",
                                          "o_he")):
            np.testing.assert_array_equal(
                g[sl].numpy(), np.asarray(w).astype(g.numpy().dtype),
                err_msg=f"{name}, trial {b}")
