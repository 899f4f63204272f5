"""The port's CUDA kernels on the card (skipped without a CUDA device).

This file imports neither jax nor the JAX package, so it runs on a GPU
host that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each hand-written kernel is held against its plain PyTorch version on
the same CUDA inputs at the n = 1e6 shapes of the main path, and the
engine with its kernels against the engine with their plain versions.
Every comparison is exact (tolerance 0): the kernels are integer code.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import addressing as A
from repro_torch.core.dht import Ring
from repro_torch.engine import make_engine
from repro_torch.engine.convert import state_to_numpy
from repro_torch.engine.problems import Majority
from repro_torch.kernels.wheel import (LAUNCHES, descent_reference,
                                       descent_tail, due_dedup,
                                       due_dedup_reference, launch_counts,
                                       reset_launches, stage_rows,
                                       stage_rows_reference, threshold_step,
                                       threshold_step_reference)
from repro_torch.kernels.wheel._common import in_segment

WW_1E6 = 262_272          # drain-window rows per cycle at n = 1e6
NL_1E6 = 3 * 2**21        # per-link plane cells at n = 1e6


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: the kernels run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_threshold_step_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))
            .to(cuda) for lo, hi, shape in ((-40, 41, (WW_1E6, 3, 2)),
                                            (-40, 41, (WW_1E6, 3, 2)),
                                            (0, 2, (WW_1E6, 1)))]
    want = threshold_step_reference(Majority(), *args)
    before = LAUNCHES["threshold_step"]
    got = threshold_step(Majority(), *args)
    torch.cuda.synchronize()
    assert LAUNCHES["threshold_step"] == before + 1
    _same(got, want)


@pytest.mark.parametrize("links", [NL_1E6 // 3, 30_000])
def test_due_dedup_kernel_matches_plain(cuda, links):
    """2^21 links spreads the window; 30,000 puts ~9 rows on each link."""
    rng = np.random.default_rng(links)
    flat = rng.integers(0, links, WW_1E6) * 3 + rng.integers(0, 3, WW_1E6)
    acc = rng.random(WW_1E6) < 0.6
    alert = rng.random(WW_1E6) < 0.2
    args = [torch.from_numpy(flat), torch.from_numpy(acc & ~alert),
            torch.from_numpy(acc & alert),
            torch.from_numpy(rng.integers(0, 50, WW_1E6).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 50, WW_1E6).astype(np.int32))]
    args = [a.to(cuda) for a in args]
    want = due_dedup_reference(*args, nl=NL_1E6)
    for _ in range(2):  # the scratch planes are reused across calls
        got = due_dedup(*args, nl=NL_1E6)
        torch.cuda.synchronize()
        _same(got, want)


def test_stage_rows_kernel_matches_plain(cuda):
    m = 1_049_088  # lanes * 4 * window_l at n = 1e6
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(
        rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.int64))
    mask = torch.from_numpy(rng.random(m) < 0.6)
    args = [rows.to(cuda), torch.from_numpy(rng.random(m) < 0.15).to(cuda),
            (torch.cumsum(mask.long(), 0) - 1).to(cuda),  # -1 before the first
            torch.from_numpy((rng.permutation(10) + 1).astype(np.int32)).to(cuda)]
    for t in (12345, 0xFFFFFFFF - 4):  # the stamp wraps at 32 bits
        want = stage_rows_reference(*args, t, 7)
        got = stage_rows(*args, t, 7)
        torch.cuda.synchronize()
        _same((got,), (want,))


def test_descent_tail_kernel_matches_plain(cuda):
    """Routing-consistent rows from a real ring's owner tables, d = 32."""
    rng = np.random.default_rng(2)
    m, n, d = 32_784, 4096, 32
    addrs = A.random_ring(n, d, seed=3).astype(np.int64)
    prev = np.roll(addrs, 1)
    pos = A.position_from_segment(torch.from_numpy(prev),
                                  torch.from_numpy(addrs), d).numpy()
    dest = rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.int64)
    origin = addrs[rng.integers(0, n, m)]
    own = np.searchsorted(addrs, dest, side="left") % n
    t = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)
    a_prev, a_self = t(prev[own]), t(addrs[own])
    args = [t(origin), t(dest),
            t(rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.int64)),
            t(rng.random(m) < 0.7), t(rng.random(m) < 0.8),
            t(rng.random(m) < 0.5), t(pos[own]), a_prev, a_self,
            in_segment(t(origin), a_prev, a_self), t(addrs[-1:])]
    want = descent_reference(*args, d)
    got = descent_tail(*args, d)
    torch.cuda.synchronize()
    _same(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rows = torch.zeros((16, 8), dtype=torch.int64, device=cuda)
    alert = torch.zeros(16, dtype=torch.bool, device=cuda)
    ordinal = torch.zeros(16, dtype=torch.int64, device=cuda)
    perm = torch.arange(1, 11, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        stage_rows(rows.int(), alert, ordinal, perm, 0, 7)
    with pytest.raises(ValueError):
        stage_rows(rows, alert.cpu(), ordinal, perm, 0, 7)
    with pytest.raises(ValueError):
        stage_rows(rows[:, ::2], alert, ordinal, perm, 0, 3)
    with pytest.raises(NotImplementedError):
        threshold_step(object(), torch.zeros((4, 3, 2), dtype=torch.int32,
                                             device=cuda),
                       torch.zeros((4, 3, 2), dtype=torch.int32, device=cuda),
                       torch.zeros((4, 1), dtype=torch.int32, device=cuda))


def test_engine_kernels_match_plain_and_launch(cuda):
    """Engine with the CUDA kernels vs with their plain versions, both on
    the card: full state equal; every kernel launched once per cycle."""
    ring = Ring.random(2000, 32, seed=4)
    votes = (np.random.default_rng(4).random(2000) < 0.45).astype(np.int64)
    a = make_engine("torch", ring, votes, seed=5, capacity_per_peer=8)
    b = make_engine("torch", ring, votes, seed=5, capacity_per_peer=8,
                    wheel_kernels="none")
    assert a.device.type == "cuda"
    reset_launches()
    a.step(120)
    b.step(120)
    counts = launch_counts()
    assert counts == {"stage_rows": 120, "threshold_step": 120,
                      "due_dedup": 120, "descent_tail": 120}
    sa, sb = state_to_numpy(a._st), state_to_numpy(b._st)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert a.dropped == 0
    a.check_conservation()
