"""`TorchEngine` against the reference engine, on the CPU.

The port's engine runs with ``device="cpu"`` (its kernel wrappers then
take their plain versions) in lockstep with
``JaxEngine(kernel="ref", wheel_kernels="none")``: the full state is
compared after every cycle and after every join/leave, field by field
and exactly (tolerance 0), through stage 1 (converge), stage 2 (vote
flip) and stage 3 (one join + one leave) of the three golden majority
cells, and the stage cycles / messages and the output/vote hashes must
be the golden jax cells' of tests/golden_majority.json.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.dht import Ring as JRing
from repro.engine.jax_backend import JaxEngine
from repro_torch.core.dht import Ring
from repro_torch.engine import TorchEngine, make_engine
from repro_torch.engine.convert import state_from_numpy, state_to_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_majority.json")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch on tiny tensors is op-overhead bound; one intra-op
    thread per test worker avoids oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _votes(n, mu, rng):
    v = np.zeros(n, np.int64)
    v[rng.choice(n, int(round(n * mu)), replace=False)] = 1
    return v


def _jax_state(je):
    return {k: np.asarray(v) for k, v in je._st._asdict().items()}


def _assert_same_state(je, te, where):
    want = _jax_state(je)
    got = state_to_numpy(te._st)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        if not np.array_equal(g, w):
            raise AssertionError(f"{where}: state field {k!r} differs")


def _lockstep(je, te):
    """Make every torch cycle step the reference too and compare."""
    cycle = te._cycle

    def both():
        cycle()
        je.step(1)
        _assert_same_state(je, te, f"cycle {te.t}")

    te._cycle = both


def _golden_jax_cells():
    with open(GOLDEN) as f:
        cells = json.load(f)["cells"]
    return [c for c in cells if c["cell"][4] == "jax"]


@pytest.mark.parametrize("idx", range(3))
def test_engine_lockstep_golden_stages(idx):
    """Full state equal after every cycle and every join/leave through
    stages 1-3; the stage cycles and messages and the output/vote hashes
    are the golden jax cell's."""
    cell = _golden_jax_cells()[idx]
    n, mu, ring_seed, eng_seed = cell["cell"][:4]
    rng = np.random.default_rng(ring_seed + 100)
    jring = JRing.random(n, 32, seed=ring_seed)
    votes = _votes(n, mu, rng)
    je = JaxEngine(jring, votes, seed=eng_seed, kernel="ref",
                   wheel_kernels="none")
    te = TorchEngine(Ring(jring.addrs, 32), votes, seed=eng_seed,
                     device="cpu")
    _assert_same_state(je, te, "after the init storm")
    _lockstep(je, te)
    res = te.run_until_converged(truth=int(2 * votes.sum() >= n),
                                 max_cycles=20_000)
    new = _votes(n, 1.0 - mu, rng)
    chg = np.nonzero(new != te.votes())[0]
    te.set_votes(chg, new[chg])
    je.set_votes(chg, new[chg])
    _assert_same_state(je, te, "after the vote flip")
    res2 = te.run_until_converged(truth=int(2 * new.sum() >= n),
                                  max_cycles=20_000)
    free = np.setdiff1d(np.arange(1, 1 << 16, dtype=np.uint64),
                        jring.addrs % (1 << 16))
    for op, args, kw in (("join", (int(free[3]),), {"vote": 1}),
                         ("leave", (0,), {})):
        getattr(te, op)(*args, **kw)
        getattr(je, op)(*args, **kw)
        _assert_same_state(je, te, f"after {op}")
    v = te.votes()
    res3 = te.run_until_converged(truth=int(2 * v.sum() >= v.size),
                                  max_cycles=20_000)
    for got, want in zip((res, res2, res3), cell["stages"]):
        assert got["converged"] == want["converged"] == 1.0
        assert (got["cycles"], got["messages"]) == (want["cycles"],
                                                    want["messages"])
    sha = lambda a: hashlib.sha256(a.astype(np.int64).tobytes()).hexdigest()
    assert sha(te.outputs()) == cell["outputs_sha"]
    assert sha(te.votes()) == cell["votes_sha"]
    assert te.dropped == 0
    te.check_conservation()
    np.testing.assert_array_equal(te.outputs(), je.outputs())


def test_resume_from_reference_state_under_deferral():
    """The reference's state at cycle 100 of a run whose work budget
    forces deferrals, carried across, steps identically for 50 cycles."""
    n = 96
    rng = np.random.default_rng(21)
    jring = JRing.random(n, 32, seed=21)
    votes = _votes(n, 0.45, rng)
    sizing = dict(work_budget=16, capacity_per_peer=4)
    je = JaxEngine(jring, votes, seed=22, kernel="ref", wheel_kernels="none",
                   **sizing)
    je.step(100)
    assert je.deferred > 0
    st = state_from_numpy(_jax_state(je))
    te = TorchEngine.from_state(Ring(jring.addrs, 32), st, seed=22,
                                device="cpu", **sizing)
    _assert_same_state(je, te, "resumed")
    _lockstep(je, te)
    te.step(50)
    assert te.t == 150 and te.deferred > 0
    te.check_conservation()


def test_port_imports_neither_jax_nor_repro():
    """The package (imported in a fresh interpreter) and chip_smoke.py
    (every import statement, including those inside functions) reach
    neither jax nor the JAX package."""
    smoke = os.path.join(os.path.dirname(SRC), "chip_smoke.py")
    with open(smoke) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert "repro_torch.engine" in mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], mods
    code = ("import sys, repro_torch, repro_torch.engine, "
            "repro_torch.kernels.wheel; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda():
    """No device means CUDA; without a card that raises — never a silent
    CPU fallback."""
    ring = Ring.random(48, 32, seed=0)
    votes = np.zeros(48, np.int64)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine("torch", ring, votes)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(ring, votes)


def test_later_slices_raise():
    """What the port refuses raises: unknown backends and wheel kernels,
    and `crash` on an engine whose fault plane is not armed (a
    RuntimeError, as the reference's)."""
    ring = Ring.random(48, 32, seed=0)
    votes = np.zeros(48, np.int64)
    with pytest.raises(ValueError):
        make_engine("jax", ring, votes, device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        make_engine("torch", ring, votes, device="cpu",
                    wheel_kernels=("bogus",))
    eng = make_engine("torch", ring, votes, device="cpu",
                      capacity_per_peer=8)
    with pytest.raises(RuntimeError, match="armed fault plane"):
        eng.crash(0)
    # the serve-layer flush re-enters the event react
    assert eng.apply_coalesced(np.array([3, 7]), np.array([1, 1])) == 2
    assert eng.votes()[[3, 7]].tolist() == [1, 1]
    eng.check_conservation()
