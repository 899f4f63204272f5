"""The port's CUDA kernels on the card (skipped without a CUDA device).

This file imports neither jax nor the JAX package, so it runs on a GPU
host that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each hand-written kernel is held against its plain PyTorch version on
the same CUDA inputs at the n = 1e6 shapes of the main path, and the
engine with its kernels against the engine with their plain versions
(majority, mean and L2, under churn; L2 at D = 9 on the general kernel;
armed with the fault plane through crashes and drops; batched trials,
each wheel kernel once a cycle for all of them; a serve replay). Every comparison
is exact
(tolerance 0): the kernels are integer code, and the L2 kernel's float32
margins keep the plain version's operation order.

The training substrate's kernels are held against their plain versions
too: `threshold_gate` exactly (one add, compare and subtract, each
rounded as the plain version rounds it; subnormals are kept, not
flushed), `rglru_scan` and `flash_attention_fwd` within the tolerances
stated at each test (float32 sums in another order; bfloat16 outputs
within one rounding step), and the gradients of the differentiable
`linear_scan` and `flash_attention` against autograd through the plain
versions.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import addressing as A
from repro_torch.core.churn import random_schedule
from repro_torch.core.dht import Ring
from repro_torch.engine import FaultConfig, make_engine
from repro_torch.engine.convert import state_to_numpy
from repro_torch.engine.problems import L2Thresh, Majority, MeanMonitor
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 mha_reference, pair_fwd)
from repro_torch.kernels.majority_step import (majority_step,
                                               majority_step_reference)
from repro_torch.kernels.rglru import (linear_scan, linear_scan_reference,
                                       rglru_scan)
from repro_torch.kernels.threshold_gate import (threshold_gate,
                                                threshold_gate_reference)
from repro_torch.kernels.wheel import (LAUNCHES, descent_reference,
                                       descent_tail, due_dedup,
                                       due_dedup_reference, launch_counts,
                                       reset_launches, stage_rows,
                                       stage_rows_reference, threshold_step,
                                       threshold_step_reference)
from repro_torch.kernels.wheel._common import in_segment, stream_of
from repro_torch.kernels.wheel.threshold_step import (l2_general_geometry,
                                                      l2_kernel_name)

WW_1E6 = 262_272          # drain-window rows per cycle at n = 1e6
NL_1E6 = 3 * 2**21        # per-link plane cells at n = 1e6
PAD_1E6 = 2**21           # event-react rows at n = 1e6
I32_EDGES = np.array([-2**31, 2**31 - 1, -2**31 + 1, 2**31 - 2, 0, -1],
                     np.int32)


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


def _ints(rng, lo, hi, shape, edge_rows=0):
    """int32 array; its first `edge_rows` rows drawn from the int32 edges."""
    a = rng.integers(lo, hi, shape).astype(np.int32)
    a[:edge_rows] = rng.choice(I32_EDGES, (edge_rows,) + tuple(shape[1:]))
    return a


@pytest.mark.parametrize("n", [WW_1E6, PAD_1E6])
def test_threshold_step_mean_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    e = n // 16  # sums and T * count wrap in int32 on these rows
    args = [torch.from_numpy(a).to(cuda) for a in (
        _ints(rng, -40_000, 40_001, (n, 3, 2), e),
        _ints(rng, -40_000, 40_001, (n, 3, 2), e),
        _ints(rng, -300, 301, (n, 1), e))]
    for prob in (MeanMonitor(tau=0.3), MeanMonitor(tau=-1e6)):
        want = threshold_step_reference(prob, *args)
        before = LAUNCHES["threshold_step_mean"]
        got = threshold_step(prob, *args)
        torch.cuda.synchronize()
        assert LAUNCHES["threshold_step_mean"] == before + 1
        _same(got, want)


def l2_inputs(rng, n, dim, scale=256):
    """L2 payloads around the tau = 1 sphere; a quarter of the rows have
    a zero vector sum and a quarter equal sums on two axes, so the cover's
    half-spaces tie in the argmax."""
    in_pay = _ints(rng, -3 * scale, 3 * scale + 1, (n, 3, dim + 1))
    out_pay = _ints(rng, -3 * scale, 3 * scale + 1, (n, 3, dim + 1))
    in_pay[..., dim] = rng.integers(0, 4, (n, 3))
    out_pay[..., dim] = rng.integers(0, 4, (n, 3))
    x = _ints(rng, -2 * scale, 2 * scale + 1, (n, dim))
    q = n // 4
    in_pay[:2 * q, :, :dim] = 0
    x[:2 * q] = 0
    if dim >= 2:
        a = rng.integers(1, 4 * scale, q)
        x[q:2 * q, 0] = a
        x[q:2 * q, 1] = a
    return in_pay, out_pay, x


def _general_cover(prob, variant, geom):
    """The cover a tiling case of the general kernel runs on (None: the
    problem's own). geom: the kernel's launch shape for that cover."""
    u, dim = prob.U, prob.data_width
    if variant == "one_dir":
        return u[:1]
    if variant == "tile_plus_1":       # 8 directions and 1
        return u[:9]
    if variant == "chunk_plus_1":      # a cover chunk and 1
        return u[:geom["dirs"] + 1]
    if variant == "tie_across_chunks":
        # +e0 opens the first chunk and +e1 the second, every other
        # direction below them: rows with K = (a, a, 0, ...) tie the two
        cm = geom["dirs"]
        e = np.eye(dim, dtype=np.float32)
        return np.concatenate([e[:1], np.repeat(-e[:1], cm - 1, 0), e[1:2],
                               np.repeat(-e[1:2], cm - 1, 0)])
    if variant == "tie_across_tiles":  # +e1 moved from direction 1 to 8
        v = u.copy()
        v[[1, 8]] = v[[8, 1]]
        return v
    return None


@pytest.mark.parametrize("n,dim,ndirs,tau,variant", [
    (WW_1E6, 2, 16, 1.0, None), (PAD_1E6, 2, 16, 1.0, None),
    (4099, 1, 16, 0.5, None), (4099, 3, 6, 0.0, None),
    (4099, 3, 16, 1.0, None), (4099, 8, 20, 1.0, None),
    # the general kernel: D > 8, and a cover past the 12,288 floats of
    # shared memory (16,384 at D = 16; 16,384 at D = 4 with 4,096 dirs)
    (PAD_1E6, 9, 18, 1.0, None), (4099, 9, 18, 0.0, None),
    (4099, 16, 1024, 1.0, None), (4099, 4, 4096, 1.0, None),
    # its tiling: n against its block of R rows (1, R - 1, R + 1, prime)
    (1, 9, 18, 1.0, None), ("R-1", 9, 18, 1.0, None),
    ("R+1", 16, 1024, 1.0, None), (10_007, 16, 1024, 0.5, None),
    # one direction; a tile of 8 and one more; a cover chunk and one more
    (4099, 9, 18, 1.0, "one_dir"), (4099, 9, 18, 1.0, "tile_plus_1"),
    (4099, 16, 1024, 1.0, "chunk_plus_1"),
    # first-maximum ties between directions in different cover chunks,
    # and in different tiles of one chunk
    (4099, 16, 1024, 1.0, "tie_across_chunks"),
    (4099, 16, 32, 1.0, "tie_across_tiles"),
    # rows at the int32 edges: K and A wrap
    (4099, 9, 18, 1.0, "int32_edges"), (4099, 16, 1024, 1.0, "int32_edges"),
    # inputs off 16-byte alignment (row views): 4-byte copies and stores
    (4099, 9, 18, 1.0, "unaligned"),
    # the smallest row block (R = 32), and columns staged in chunks
    (997, 150, 300, 1.0, "rows_32"), (301, 300, 600, 1.0, "col_chunks")])
def test_threshold_step_l2_kernel_matches_plain(cuda, n, dim, ndirs, tau,
                                                variant):
    prob = L2Thresh(tau=tau, dim=dim, ndirs=ndirs)
    if dim > 8 or dim * ndirs > 12_288:
        geom = l2_general_geometry(dim, ndirs)
        cover = _general_cover(prob, variant, geom)
        if cover is not None:  # set before the wrapper uploads the cover
            prob.U = np.ascontiguousarray(cover, np.float32)
        geom = l2_general_geometry(dim, prob.U.shape[0])
        if isinstance(n, str):
            n = geom["rows"] + (1 if n == "R+1" else -1)
        if variant == "chunk_plus_1":
            assert prob.U.shape[0] > geom["dirs"]  # two chunks
        if variant == "rows_32":
            assert (geom["rows"], geom["resident"]) == (32, 1)
        if variant == "col_chunks":
            assert geom["resident"] == 0 and geom["cols"] < dim + 1
    rng = np.random.default_rng(n + dim)
    skip = 1 if variant == "unaligned" else 0  # rows 1.. of n + 1
    arrays = l2_inputs(rng, n + skip, dim)
    if variant == "int32_edges":  # the last eighth of the rows
        e = n // 8
        for a in arrays:
            a[n - e:] = rng.choice(I32_EDGES, (e,) + a.shape[1:])
    args = [torch.from_numpy(a).to(cuda)[skip:] for a in arrays]
    if skip:
        assert all(a.is_contiguous() and a.data_ptr() % 16 for a in args)
    want = threshold_step_reference(prob, *args)
    form = l2_kernel_name(dim, prob.U.shape[0])
    assert (form == "threshold_step_l2_general") == (
        dim > 8 or dim * prob.U.shape[0] > 12_288)
    before = LAUNCHES[form]
    got = threshold_step(prob, *args)
    torch.cuda.synchronize()
    assert LAUNCHES[form] == before + 1
    _same(got, want)


def test_majority_step_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    n = PAD_1E6
    planes = [torch.from_numpy(_ints(rng, 0, 60, (n, 3), n // 16)).to(cuda)
              for _ in range(4)]
    x = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(cuda)
    want = majority_step_reference(*planes, x)
    before = LAUNCHES["majority_step"]
    got = majority_step(*planes, x)
    torch.cuda.synchronize()
    assert LAUNCHES["majority_step"] == before + 1
    _same(got, want)


def _dedup_window(ww, links, seed, alerts=0.2):
    """A drain window of `ww` rows over `links` peers' links; links=0: the
    first 3 (ww // 8) rows hit every direction of ww // 8 peers once, the
    rest fall on them at random."""
    rng = np.random.default_rng(seed)
    if links:
        flat = rng.integers(0, links, ww) * 3 + rng.integers(0, 3, ww)
    else:
        nd = 3 * (ww // 8)
        flat = np.concatenate([rng.permutation(nd),
                               rng.integers(0, nd, ww - nd)])
    acc = rng.random(ww) < 0.6
    alert = rng.random(ww) < alerts
    args = [torch.from_numpy(flat), torch.from_numpy(acc & ~alert),
            torch.from_numpy(acc & alert),
            torch.from_numpy(rng.integers(0, 50, ww).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 50, ww).astype(np.int32))]
    return [a.cuda() for a in args]


@pytest.mark.parametrize("links", [NL_1E6 // 3, 30_000, 0])
def test_due_dedup_kernel_matches_plain(cuda, links):
    """2^21 links spreads the window; 30,000 puts ~9 rows on each link;
    0 hits every direction of WW / 8 peers (~8 rows a peer, a best and an
    abest on most directions). The scratch is reused across calls: the
    window, again, another window (it meets the first call's cells), the
    first again."""
    windows = [_dedup_window(WW_1E6, links, links + i, 0.3 if not links
                             else 0.2) for i in range(2)]
    wants = [due_dedup_reference(*a, nl=NL_1E6) for a in windows]
    for i in (0, 0, 1, 0):
        got = due_dedup(*windows[i], nl=NL_1E6)
        torch.cuda.synchronize()
        _same(got, wants[i])


def test_due_dedup_scratch_resets(cuda):
    """One scratch through a change of window width (the stamp's value
    bits change: the records are zeroed) and past its last epoch (zeroed,
    epoch 1 again): every call still equals the plain version."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.wheel.due_dedup")
    nl = 3 * 50_000
    small, big = (_dedup_window(ww, 50_000, ww) for ww in (1000, WW_1E6))
    want_s, want_b = (due_dedup_reference(*a, nl=nl) for a in (small, big))
    for args, want in ((big, want_b), (small, want_s), (big, want_b)):
        _same(due_dedup(*args, nl=nl), want)
    st = next(v for k, v in mod._PLANES.items() if k[1] == nl)
    st[1] = (1 << (32 - st[2])) - 2  # the next call takes the last epoch
    for _ in range(3):
        _same(due_dedup(*big, nl=nl), want_b)
    assert st[1] == 2  # the last epoch, wrapped to 1, then one more


@pytest.mark.parametrize("roww", [8, 9])  # majority/mean; L2 with D = 2
def test_stage_rows_kernel_matches_plain(cuda, roww):
    m = 1_049_088  # lanes * 4 * window_l at n = 1e6
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(
        rng.integers(0, 2**32, (m, roww), dtype=np.uint64).astype(np.int64))
    mask = torch.from_numpy(rng.random(m) < 0.6)
    args = [rows.to(cuda), torch.from_numpy(rng.random(m) < 0.15).to(cuda),
            (torch.cumsum(mask.long(), 0) - 1).to(cuda),  # -1 before the first
            torch.from_numpy((rng.permutation(10) + 1).astype(np.int32))[None]
            .to(cuda)]
    for t in (12345, 0xFFFFFFFF - 4):  # the stamp wraps at 32 bits
        t = torch.from_numpy(np.asarray([t], np.uint32).view(np.int32)).to(
            cuda)
        want = stage_rows_reference(*args, t, roww - 1)
        got = stage_rows(*args, t, roww - 1)
        torch.cuda.synchronize()
        _same((got,), (want,))


@pytest.mark.parametrize("m,live_p", [
    (32_784, 0.8),   # the engine's narrow-tail width at n = 1e6
    (32_784, 1.0),   # every row live
    (32_784, 0.0),   # no row live: every row passes through
    (1, 1.0),        # one row
    (1, 0.0),
    (1000, 0.5),     # M not a multiple of the block
])
def test_descent_tail_kernel_matches_plain(cuda, m, live_p):
    """Routing-consistent rows from a real ring's owner tables, d = 32."""
    rng = np.random.default_rng(2)
    n, d = 4096, 32
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
            t(rng.random(m) < 0.7), t(rng.random(m) < live_p),
            t(rng.random(m) < 0.5), t(pos[own]), a_prev, a_self,
            in_segment(t(origin), a_prev, a_self), t(addrs[-1:])]
    want = descent_reference(*args, d)
    before = LAUNCHES["descent_tail"]
    got = descent_tail(*args, d)
    torch.cuda.synchronize()
    assert LAUNCHES["descent_tail"] == before + 1
    _same(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rows = torch.zeros((16, 8), dtype=torch.int64, device=cuda)
    alert = torch.zeros(16, dtype=torch.bool, device=cuda)
    ordinal = torch.zeros(16, dtype=torch.int64, device=cuda)
    perm = torch.arange(1, 11, dtype=torch.int32, device=cuda)[None]
    t0 = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        stage_rows(rows.int(), alert, ordinal, perm, t0, 7)
    with pytest.raises(ValueError):
        stage_rows(rows, alert.cpu(), ordinal, perm, t0, 7)
    with pytest.raises(ValueError):
        stage_rows(rows[:, ::2], alert, ordinal, perm, t0, 3)
    with pytest.raises(NotImplementedError):
        threshold_step(object(), torch.zeros((4, 3, 2), dtype=torch.int32,
                                             device=cuda),
                       torch.zeros((4, 3, 2), dtype=torch.int32, device=cuda),
                       torch.zeros((4, 1), dtype=torch.int32, device=cuda))
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # L2 with D = 2 wants P = 3
        threshold_step(L2Thresh(dim=2), z(4, 3, 2), z(4, 3, 2), z(4, 2))
    with pytest.raises(ValueError):
        majority_step(z(4, 3), z(4, 3), z(4, 3), z(4, 3), z(5))
    i64 = torch.zeros(8, dtype=torch.int64, device=cuda)
    flag = torch.zeros(8, dtype=torch.bool, device=cuda)
    drow = [i64, i64, i64, flag, flag, flag, i64, i64, i64, flag, i64[:1]]
    with pytest.raises(TypeError):
        descent_tail(i64.int(), *drow[1:], 32)
    with pytest.raises(ValueError):  # a strided row
        descent_tail(*drow[:4], torch.zeros(16, dtype=torch.bool,
                                            device=cuda)[::2], *drow[5:], 32)
    with pytest.raises(ValueError):  # rows of different lengths
        descent_tail(*drow[:9], flag[:7], drow[10], 32)


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
                      "due_dedup": 120, "descent_tail": 120,
                      "threshold_step_mean": 0, "threshold_step_l2": 0,
                      "threshold_step_l2_general": 0, "majority_step": 0,
                      "threshold_gate": 0, "rglru_scan": 0,
                      "flash_attention_fwd": 0}
    sa, sb = state_to_numpy(a._st), state_to_numpy(b._st)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert a.dropped == 0
    a.check_conservation()


def _problem_data(name, n, rng, phase):
    """Golden-cell-like raw data (mean: N(-+0.6, 0.8); L2: a cloud around
    a mean outside / inside the tau = 1 ball)."""
    if name == "mean":
        return rng.normal(-0.6 if phase == 0 else 0.6, 0.8, size=n)
    c = np.array([0.6, -0.8]) * (1.3 if phase == 0 else 0.45)
    return rng.normal(c, 0.9, size=(n, 2))


@pytest.mark.parametrize("name", ["mean", "l2"])
def test_engine_problems_kernels_match_plain_under_churn(cuda, name):
    """Mean / L2 engines with the CUDA kernels vs with their plain
    versions, both on the card, through a data flip and a churn
    schedule: full state equal; the problem's threshold form launched."""
    n = 4096
    rng = np.random.default_rng(9)
    ring = Ring.random(n, 32, seed=9)
    prob = MeanMonitor(tau=0.3) if name == "mean" else L2Thresh(tau=1, dim=2)
    data = _problem_data(name, n, rng, 0)
    engs = [make_engine("torch", ring, data, seed=10, capacity_per_peer=8,
                        problem=prob, wheel_kernels=wk)
            for wk in ("auto", "none")]
    reset_launches()
    new = _problem_data(name, n, rng, 1)
    sched = random_schedule(ring, 6, seed=11, spacing=15)
    for e in engs:
        e.step(60)
        e.apply_coalesced(np.arange(n), new)
        sched.apply(e)
    form = "threshold_step_mean" if name == "mean" else "threshold_step_l2"
    counts = launch_counts()
    assert counts[form] == 60 + 1 + 6 * 15 and counts["threshold_step"] == 0
    sa, sb = state_to_numpy(engs[0]._st), state_to_numpy(engs[1]._st)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert engs[0].dropped == 0
    engs[0].check_conservation()


def test_engine_l2_any_dim_kernels_match_plain(cuda):
    """An L2 engine at D = 9 (the general kernel) with the CUDA kernels vs
    with their plain versions, through a data flip: full state equal."""
    n, dim = 4096, 9
    rng = np.random.default_rng(15)
    ring = Ring.random(n, 32, seed=15)
    prob = L2Thresh(tau=1.0, dim=dim)
    c = np.zeros(dim)
    c[:2] = 0.6, -0.8
    data = rng.normal(1.3 * c, 0.9, (n, dim))
    engs = [make_engine("torch", ring, data, seed=16, capacity_per_peer=8,
                        problem=prob, wheel_kernels=wk)
            for wk in ("auto", "none")]
    reset_launches()
    new = rng.normal(0.45 * c, 0.9, (n, dim))
    for e in engs:
        e.step(40)
        e.apply_coalesced(np.arange(n), new)
        e.step(40)
    counts = launch_counts()
    assert counts["threshold_step_l2_general"] == 40 + 1 + 40
    assert counts["threshold_step_l2"] == 0
    sa, sb = state_to_numpy(engs[0]._st), state_to_numpy(engs[1]._st)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert engs[0].dropped == 0


@pytest.mark.parametrize("mode", ["crash", "drop"])
def test_engine_fault_plane_kernels_match_plain(cuda, mode):
    """Armed engines with the CUDA kernels vs with their plain versions,
    through crashes and their evictions (or a lossy run) and a join:
    full state, evictions and losses equal; the dedup kernel stays off."""
    n = 2048
    ring = Ring.random(n, 32, seed=17)
    votes = (np.random.default_rng(17).random(n) < 0.45).astype(np.int64)
    f = (FaultConfig(suspect_after=25, evict_after=150, seed=3)
         if mode == "crash" else
         FaultConfig(p_drop=0.1, p_delay=0.05, suspect_after=25, seed=3))
    reset_launches()
    engs = [make_engine("torch", ring, votes, seed=18, capacity_per_peer=8,
                        faults=f, wheel_kernels=wk) for wk in ("auto", "none")]
    for e in engs:
        e.step(40)
        if mode == "crash":
            for k in (100, 900, 1500):
                e.crash(k)
        for _ in range(36):  # the eviction sweep runs after each step
            e.step(10)
        e.join(12345, vote=1)
        e.step(40)
    counts = launch_counts()
    assert counts["due_dedup"] == 0
    assert min(counts[k] for k in ("stage_rows", "threshold_step",
                                   "descent_tail")) > 0
    a, b = engs
    sa, sb = state_to_numpy(a._st), state_to_numpy(b._st)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert a.evictions == b.evictions and a.lost_to_fault == b.lost_to_fault
    assert len(a.evictions) == (3 if mode == "crash" else 0)
    assert a.lost_to_fault > 0 and a.dropped == 0
    a.check_conservation()


def test_engine_majority_step_route_matches_plain(cuda):
    """A majority engine without the threshold kernel runs its event
    react through the majority_step kernel; equal to the plain engine."""
    ring = Ring.random(2000, 32, seed=12)
    votes = (np.random.default_rng(12).random(2000) < 0.45).astype(np.int64)
    reset_launches()
    a = make_engine("torch", ring, votes, seed=13, capacity_per_peer=8,
                    wheel_kernels=("dedup", "enqueue", "descent"))
    b = make_engine("torch", ring, votes, seed=13, capacity_per_peer=8,
                    wheel_kernels="none")
    sched = random_schedule(ring, 4, seed=14, spacing=20)
    for e in (a, b):
        e.step(50)
        e.apply_coalesced(np.arange(0, 2000, 7), np.ones(286, np.int64))
        sched.apply(e)
    counts = launch_counts()
    assert counts["majority_step"] == 2 and counts["threshold_step"] == 0
    assert counts["due_dedup"] == 50 + 4 * 20
    sa, sb = state_to_numpy(a._st), state_to_numpy(b._st)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


# -- batched trials and the serve layer -------------------------------------

@pytest.mark.parametrize("batch", [1, 4])
def test_stage_rows_per_trial_kernel_matches_plain(cuda, batch):
    """(B, 10) perms and (B,) times over B trial-major blocks (B = 1:
    the single engine's call)."""
    m = batch * 65_568  # a trial's staged rows at n = 1e5
    rng = np.random.default_rng(21)
    rows = torch.from_numpy(rng.integers(0, 2**32, (m, 8), dtype=np.uint64)
                            .astype(np.int64)).to(cuda)
    alert = torch.from_numpy(rng.random(m) < 0.15).to(cuda)
    ordinal = (torch.cumsum(torch.from_numpy(rng.random(m) < 0.6).long(), 0)
               - 1).to(cuda)
    perm = torch.from_numpy(np.stack([rng.permutation(10) + 1 for _ in range(
        batch)]).astype(np.int32)).to(cuda)
    t = torch.tensor([12345, -5, 7, 2**31 - 1][:batch], dtype=torch.int32,
                     device=cuda)
    args = (rows, alert, ordinal, perm, t, 7)
    want = stage_rows_reference(*args)
    before = LAUNCHES["stage_rows"]
    got = stage_rows(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["stage_rows"] == before + 1
    _same((got,), (want,))


@pytest.mark.parametrize("batch", [1, 4])
def test_descent_tail_per_trial_kernel_matches_plain(cuda, batch):
    """B trial-major blocks of rows on B rings, each with its own ring
    maximum; at B = 1 the single engine's one-element max_addr."""
    rng = np.random.default_rng(22)
    n, d, m = 4096, 32, 8_196
    cols = []
    for b in range(batch):
        addrs = A.random_ring(n, d, seed=30 + b).astype(np.int64)
        prev = np.roll(addrs, 1)
        pos = A.position_from_segment(torch.from_numpy(prev),
                                      torch.from_numpy(addrs), d).numpy()
        dest = rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.int64)
        own = np.searchsorted(addrs, dest, side="left") % n
        cols.append([addrs[rng.integers(0, n, m)], dest,
                     rng.integers(0, 2**d, m, dtype=np.uint64).astype(
                         np.int64), rng.random(m) < 0.7,
                     rng.random(m) < 0.8, rng.random(m) < 0.5, pos[own],
                     prev[own], addrs[own], addrs[-1]])
    t = lambda a: torch.from_numpy(np.asarray(a)).to(cuda)
    args = [t(np.concatenate(c)) for c in zip(*[c[:9] for c in cols])]
    args.insert(9, in_segment(args[0], args[7], args[8]))
    max_addr = t(np.asarray([c[9] for c in cols], np.int64))
    want = descent_reference(*args, max_addr, d)
    before = LAUNCHES["descent_tail"]
    got = descent_tail(*args, max_addr, d)
    torch.cuda.synchronize()
    assert LAUNCHES["descent_tail"] == before + 1
    _same(got, want)


def _trial_states(eng):
    from repro_torch.engine.convert import trials_to_numpy

    return trials_to_numpy(eng._eng._st, eng.batch)


def test_batched_engine_kernels_match_plain_and_launch(cuda):
    """Four majority trials on four rings, kernels-on vs plain, both on
    the card: each wheel kernel launches once a cycle for all four; full
    state equal per trial through converge, a ragged flip and a second
    run at different t."""
    B, n = 4, 4096
    rng = np.random.default_rng(23)
    rings = [Ring.random(n, 32, seed=40 + b) for b in range(B)]
    votes = np.stack([(rng.random(n) < mu).astype(np.int64)
                      for mu in (0.4, 0.45, 0.55, 0.6)])
    a, b = (make_engine("torch", rings, votes, seed=5, batch=B,
                        capacity_per_peer=8, wheel_kernels=wk)
            for wk in ("auto", "none"))
    reset_launches()
    a.step(30)
    b.step(30)
    assert launch_counts() == {
        "stage_rows": 30, "threshold_step": 30, "due_dedup": 30,
        "descent_tail": 30, "threshold_step_mean": 0, "threshold_step_l2": 0,
        "threshold_step_l2_general": 0, "majority_step": 0,
        "threshold_gate": 0, "rglru_scan": 0, "flash_attention_fwd": 0}

    def same(where):
        for tb, (sa, sb) in enumerate(zip(_trial_states(a), _trial_states(b))):
            for k in sa:
                assert np.array_equal(sa[k], sb[k]), (where, tb, k)

    same("step")
    truths = (2 * votes.sum(1) >= n).astype(np.int64)
    ra = a.run_until_converged(truths)
    assert ra == b.run_until_converged(truths)
    assert all(r["converged"] == 1.0 for r in ra)
    same("converged")
    idx = np.full((B, 600), -1)
    idx[1] = np.arange(600) * 5
    idx[3, :7] = np.arange(7)
    for e in (a, b):
        e.set_votes(idx, np.zeros((B, 600), np.int64))
    same("ragged flip")
    truths = (2 * a.votes().sum(1) >= n).astype(np.int64)
    ra = a.run_until_converged(truths)
    assert ra == b.run_until_converged(truths)
    same("second run")
    assert (a.dropped == 0).all()
    a.check_conservation()


def test_serve_replay_kernels_match_plain(cuda):
    """One seeded serve workload (submits, churn, subscriber flips)
    through a ThresholdServer over the engine with its kernels and with
    their plain versions: the same transitions, outputs and state."""
    from repro_torch.launch.serve import (ThresholdServer, gen_workload,
                                          replay_workload)

    n = 2048
    ring = Ring.random(n, 32, seed=24)
    votes = (np.random.default_rng(24).random(n) < 0.4).astype(np.int64)
    work = gen_workload(ring, "majority", windows=20, seed=25, rate=80.0,
                        p_churn=0.5, window_cycles=8, p_flip_sub=0.25)
    runs = []
    for wk in ("auto", "none"):
        eng = make_engine("torch", ring, votes, seed=26, capacity_per_peer=8,
                          wheel_kernels=wk)
        server = ThresholdServer(eng, window=8)
        trs = []
        server.subscribe(lambda tr: trs.append((tr.t, tr.peers, tr.output)))
        replay_workload(server, work,
                        after_pump=lambda _i: eng.check_conservation())
        runs.append((eng, trs, server.stats()))
    (a, ta, sa), (b, tb, sb) = runs
    assert ta == tb and ta and sa == sb and sa["dropped"] == 0
    np.testing.assert_array_equal(a.outputs(), b.outputs())
    xa, xb = state_to_numpy(a._st), state_to_numpy(b._st)
    for k in xa:
        assert np.array_equal(xa[k], xb[k]), k


# -- the training substrate's kernels ---------------------------------------

def _bits_equal(a, b):
    """Bit-for-bit equal (signed zeros and subnormals included), NaN
    where NaN (a NaN's payload is not compared)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    assert torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


@pytest.mark.parametrize("n,tau,gdt,rdt", [
    (1_000_003, 1e-4, torch.float32, torch.float32),  # ragged length
    (4097, 0.0, torch.float32, torch.float32),  # tau <= 0: everything sent
    (4097, -1.0, torch.float32, torch.float32),
    (65_537, 0.5, torch.bfloat16, torch.float32),  # bf16 in, fp32 residual
    (65_537, 0.5, torch.bfloat16, torch.bfloat16)])
def test_threshold_gate_kernel_matches_plain(cuda, n, tau, gdt, rdt):
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-3)
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-3)
    g[:7] = torch.tensor([0.0, -0.0, 1e-40, -1e-40, tau, -tau, float("nan")])
    g, r = g.to(gdt).to(cuda), r.to(rdt).to(cuda)
    want = threshold_gate_reference(g, r, tau)
    before = LAUNCHES["threshold_gate"]
    got = threshold_gate(g, r, tau)
    torch.cuda.synchronize()
    assert LAUNCHES["threshold_gate"] == before + 1
    for a, b in zip(got[:2], want[:2]):
        _bits_equal(a, b)
    assert got[2].dtype == torch.int32 and int(got[2]) == int(want[2])
    if tau <= 0:
        assert int(got[2]) == n - 1  # every element but the NaN


def test_threshold_gate_keeps_subnormals(cuda):
    """The build does not flush subnormals to zero: a subnormal sum is
    sent (tau 0) and kept in the residual (tau 1) as the plain version
    keeps it."""
    g = torch.tensor([1e-40, -3e-39, 1e-45, 0.0], device=cuda)
    r = torch.tensor([1e-40, 0.0, 0.0, 1e-41], device=cuda)
    s0, n0, c0 = threshold_gate(g, r, 0.0)
    s1, n1, c1 = threshold_gate(g, r, 1.0)
    acc = (g.cpu() + r.cpu()).to(cuda)  # the CPU keeps subnormals
    _bits_equal(s0, acc)
    _bits_equal(n1, acc)
    assert (acc[[0, 1, 3]] != 0).all()
    assert int(c0) == 4 and int(c1) == 0


def _close(got, want, atol, rtol=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# float32: sums of T products in another order (the plain version is a
# doubling scan); bfloat16: outputs within one rounding step (2^-8 rel.)
SCAN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 8e-3)}
# T at the kernel's tile edges in both dtypes (tiles of 64 steps at
# float32, 128 at bfloat16), W at and past the 32-channel slab, B = 1 and 3
SCAN_EDGES = [(b, t, w, b > 1) for t in (1, 63, 64, 65, 127, 128, 129, 4097)
              for w in (8, 40, 4104) for b in (1, 3)]
# unaligned rows (W * itemsize % 16 != 0) take the kernel's scalar loads
SCAN_CASES = [(2, 77, 96, True), (3, 200, 40, False), (1, 4096, 4096, False),
              (2, 130, 37, True), (1, 300, 4093, False)] + SCAN_EDGES


def _scan_inputs(cuda, dtype, b, t, w, with_h0, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.rand((b, t, w), generator=gen, device=cuda) * 0.2 + 0.8
    u = torch.randn((b, t, w), generator=gen, device=cuda) * 0.1
    h0 = torch.randn((b, w), generator=gen, device=cuda) if with_h0 else None
    return a.to(dtype), u.to(dtype), None if h0 is None else h0.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w,with_h0", SCAN_CASES)
def test_rglru_scan_kernel_matches_plain(cuda, dtype, b, t, w, with_h0):
    """One launch a call."""
    a, u, h0 = _scan_inputs(cuda, dtype, b, t, w, with_h0, seed=t)
    want = linear_scan_reference(a, u, h0)
    before = LAUNCHES["rglru_scan"]
    got = rglru_scan(a, u, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    atol, rtol = SCAN_TOL[dtype]
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol, rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w,with_h0", [(2, 77, 96, True),
                                           (3, 129, 40, False),
                                           (1, 4097, 4104, True),
                                           (2, 130, 37, False)])
def test_rglru_scan_reverse_kernel_matches_plain(cuda, dtype, b, t, w,
                                                 with_h0):
    a, u, h0 = _scan_inputs(cuda, dtype, b, t, w, with_h0, seed=t * w)
    want = linear_scan_reference(a, u, h0, reverse=True)
    got = rglru_scan(a, u, h0, reverse=True)
    torch.cuda.synchronize()
    atol, rtol = SCAN_TOL[dtype]
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol, rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_rglru_scan_cumsum_carry_is_exact(cuda, dtype, reverse):
    """a = 1 and u, h0 in eighths: h is a running sum that float32 holds
    exactly (|h| <= 4097, 1/8 apart), in the kernel and in the plain
    version alike, so they must be equal. A carry rounded through
    bfloat16, or a lane's pair folded in the wrong place, shows here."""
    rng = np.random.default_rng(11)
    b, t, w = 2, 4097, 4104
    u = torch.from_numpy(rng.integers(-8, 9, (b, t, w)) / 8).to(cuda, dtype)
    h0 = torch.from_numpy(rng.integers(-64, 65, (b, w)) / 8).to(cuda, dtype)
    a = torch.ones_like(u)
    want = linear_scan_reference(a, u, h0, reverse=reverse)
    got = rglru_scan(a, u, h0, reverse=reverse)
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_unaligned_pointer(cuda, dtype):
    """a and u one element past a 16-byte boundary (W a multiple of 8):
    the scalar-load path, one launch."""
    b, t, w = 1, 300, 64
    a, u, h0 = _scan_inputs(cuda, dtype, b, t, w, True, seed=9)
    buf = torch.empty(2, b * t * w + 1, dtype=dtype, device=cuda)
    buf[0, 1:], buf[1, 1:] = a.flatten(), u.flatten()
    ao, uo = buf[0, 1:].view(b, t, w), buf[1, 1:].view(b, t, w)
    assert ao.data_ptr() % 16 and uo.data_ptr() % 16
    want = linear_scan_reference(a, u, h0)
    before = LAUNCHES["rglru_scan"]
    got = rglru_scan(ao, uo, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    atol, rtol = SCAN_TOL[dtype]
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol, rtol)


def test_stream_of_is_the_current_stream(cuda):
    """Every wrapper launches on `stream_of`'s raw handle, read through a
    private torch call: it must be the current stream's, on the default
    stream and under another one, with and without a device index."""
    devs = (cuda, torch.device("cuda", torch.cuda.current_device()))
    for dev in devs:
        assert stream_of(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(device=cuda)
    with torch.cuda.stream(side):
        for dev in devs:
            assert stream_of(dev) == side.cuda_stream
            assert stream_of(dev) == torch.cuda.current_stream(dev).cuda_stream
    assert stream_of(cuda) != side.cuda_stream


def _sequential_scan(a, u, h0):
    """The recurrence as a plain loop, differentiable by autograd."""
    h, out = h0, []
    for i in range(a.shape[1]):
        h = a[:, i] * h + u[:, i]
        out.append(h)
    return torch.stack(out, 1), h


def test_linear_scan_gradients_match_autograd(cuda):
    """da, du, dh0 of the Function (forward and reversed backward scan on
    the kernel) against autograd through the plain loop, float32."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, t, w = 2, 45, 70  # T not a multiple of 32
    a = torch.rand((b, t, w), generator=gen, device=cuda) * 0.5 + 0.5
    u = torch.randn((b, t, w), generator=gen, device=cuda)
    h0 = torch.randn((b, w), generator=gen, device=cuda)
    wh = torch.randn((b, t, w), generator=gen, device=cuda)
    wl = torch.randn((b, w), generator=gen, device=cuda)
    grads = []
    for fn in (lambda *x: linear_scan(*x, use_kernel=True), _sequential_scan):
        xs = [x.clone().requires_grad_() for x in (a, u, h0)]
        h, hl = fn(*xs)
        ((h * wh).sum() + (hl * wl).sum()).backward()
        grads.append([x.grad for x in xs])
    before = LAUNCHES["rglru_scan"]
    linear_scan(a, u, h0)[0].sum()  # forward only: one launch
    assert LAUNCHES["rglru_scan"] == before + 1
    for got, want in zip(*grads):
        _close(got, want, 1e-4, 1e-4)


# float32: dot products and exponentials in another order / library
# (CUDA expf vs PyTorch's); bfloat16 output within one rounding step
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,q_offset", [
    (2, 9, 3, 200, 200, 64, True, None, 0),     # GQA 9/3, S not a tile multiple
    (1, 16, 1, 300, 300, 256, True, 48, 0),     # MQA, band, head dim 256
    (1, 4, 1, 64, 160, 128, True, 40, 96),      # q_offset > 0
    (2, 4, 2, 96, 96, 32, False, None, 0),      # bidirectional
    (1, 2, 2, 50, 50, 16, True, 7, 0),
    # the tensor-core route's tile edges (64 keys, 128 q rows a CTA):
    (1, 4, 2, 130, 130, 128, True, None, 0),    # S past two tiles
    (2, 9, 3, 100, 200, 64, True, 24, 100),     # GQA, q_offset, window < tile
    (1, 16, 1, 130, 65, 256, True, 7, 0),       # MQA; rows 72+ see no key
    (1, 2, 1, 200, 200, 32, False, 20, 0),      # bidirectional window
    (2, 4, 4, 96, 96, 16, True, 100, 0)])       # window past S
def test_flash_attention_fwd_kernel_matches_plain(cuda, dtype, b, hq, hkv, sq,
                                                  skv, dh, causal, window,
                                                  q_offset):
    gen = torch.Generator(device=cuda).manual_seed(sq + dh)
    q = torch.randn((b, hq, sq, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, skv, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, skv, dh), generator=gen, device=cuda).to(dtype)
    want_o, want_lse = pair_fwd(q, k, v, causal, window, None, q_offset)
    before = LAUNCHES["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal, window, None, q_offset)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    _close(o, want_o, FLASH_TOL[dtype], FLASH_TOL[dtype])
    _close(lse, want_lse, 1e-4, 1e-5)
    _close(o.float(), mha_reference(q.float(), k.float(), v.float(), causal,
                                    window, None, q_offset),
           FLASH_TOL[dtype], FLASH_TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24)])
def test_flash_attention_gradients_match_autograd(cuda, causal, window):
    """dq, dk, dv of the Function (kernel forward, plain FA2 backward from
    the kernel's o and lse) against autograd through `mha_reference`,
    float32, GQA 6/2."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    shapes = [(2, 6, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64)]
    qkv = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    gout = torch.randn(shapes[0], generator=gen, device=cuda)
    grads = []
    for fn in (lambda *x: flash_attention(*x, causal, window),
               lambda *x: mha_reference(*x, causal, window)):
        xs = [x.clone().requires_grad_() for x in qkv]
        (fn(*xs) * gout).sum().backward()
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        _close(got, want, 1e-4, 1e-4)


def test_training_kernel_wrappers_reject_what_they_do_not_take(cuda):
    f = lambda *s: torch.zeros(s, device=cuda)
    with pytest.raises(ValueError):
        threshold_gate(f(8), f(9), 0.1)
    with pytest.raises(TypeError):
        threshold_gate(f(8).double(), f(8).double(), 0.1)
    with pytest.raises(ValueError):
        threshold_gate(f(8, 2)[:, 0], f(8), 0.1)
    with pytest.raises(TypeError):
        rglru_scan(f(1, 4, 8), f(1, 4, 8).bfloat16())
    with pytest.raises(ValueError):
        rglru_scan(f(1, 4, 8), f(1, 4, 8), f(2, 8))
    with pytest.raises(ValueError):  # head dim 48 is not built
        flash_attention_fwd(f(1, 2, 8, 48), f(1, 1, 8, 48), f(1, 1, 8, 48))
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv
        flash_attention_fwd(f(1, 3, 8, 64), f(1, 2, 8, 64), f(1, 2, 8, 64))
    with pytest.raises(ValueError):
        flash_attention_fwd(f(1, 2, 64, 8).transpose(2, 3), f(1, 1, 8, 64),
                            f(1, 1, 8, 64))
    with pytest.raises(ValueError):  # bf16 rows are copied 16 bytes at once
        b = lambda *s: f(s[0] * s[1] * s[2] * s[3] + 1).bfloat16()[1:].view(s)
        flash_attention_fwd(b(1, 2, 8, 64), b(1, 1, 8, 64), b(1, 1, 8, 64))


# (B, Hq, Hkv, Sq, Skv, Dqk, Dv, causal, window, q_offset): v narrower
# than q and k, MLA's full widths (DeepSeek-V3) and its smoke config's
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dk,dv,causal,window,q_offset", [
    (1, 4, 4, 300, 300, 192, 128, True, None, 0),   # S not a tile multiple
    (2, 2, 2, 130, 130, 192, 128, False, None, 0),  # bidirectional
    (1, 4, 2, 100, 200, 192, 128, True, 24, 100),   # GQA, band, q_offset
    (2, 4, 4, 96, 96, 24, 16, True, None, 0),       # widths padded to 64
    (1, 2, 1, 70, 150, 24, 16, False, None, 0)])    # MQA, ragged keys
def test_flash_attention_fwd_value_width_matches_plain(cuda, dtype, b, hq,
                                                       hkv, sq, skv, dk, dv,
                                                       causal, window,
                                                       q_offset):
    """The kernels at a value width unlike the key width (o as wide as
    v, scale Dqk^-0.5) against `pair_fwd` and `mha_reference`, within
    the square forms' tolerances."""
    gen = torch.Generator(device=cuda).manual_seed(sq + dk)
    q = torch.randn((b, hq, sq, dk), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, skv, dk), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, skv, dv), generator=gen, device=cuda).to(dtype)
    want_o, want_lse = pair_fwd(q, k, v, causal, window, None, q_offset)
    before = LAUNCHES["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal, window, None, q_offset)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    assert o.shape == (b, hq, sq, dv)
    _close(o, want_o, FLASH_TOL[dtype], FLASH_TOL[dtype])
    _close(lse, want_lse, 1e-4, 1e-5)
    _close(o.float(), mha_reference(q.float(), k.float(), v.float(), causal,
                                    window, None, q_offset),
           FLASH_TOL[dtype], FLASH_TOL[dtype])


def test_flash_attention_fwd_rejects_unbuilt_width_pairs(cuda):
    f = lambda *s: torch.zeros(s, device=cuda)
    with pytest.raises(ValueError):  # (64, 32) is not built
        flash_attention_fwd(f(1, 2, 8, 64), f(1, 2, 8, 64), f(1, 2, 8, 32))
    with pytest.raises(ValueError):  # v's keys differ from k's
        flash_attention_fwd(f(1, 2, 8, 192), f(1, 2, 8, 192),
                            f(1, 2, 9, 128))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_moe_smoke_models_kernels_match_plain(cuda, arch):
    """DeepSeek's and Arctic's smoke configs (float32) on the card: a
    prefill and 3 decode steps with the kernels against the same with
    their plain versions (DeepSeek's MLA prefill through the (24, 16)
    kernel, once a layer); logits and cache within 1e-4 relative."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    cfg = get_smoke_config(arch)
    if cfg.hd not in (16, 32, 64, 128, 256) and cfg.mla is None:
        cfg = dataclasses.replace(cfg, head_dim=16)  # Arctic smoke's is 8
    plain = dataclasses.replace(cfg, use_kernels=False)
    params = M.init_params(cfg, 3, cuda)
    for t in leaves(params):  # the zero router_bias: drawn
        if not t.any():
            t.normal_(0.0, 0.5, generator=torch.Generator(device=cuda)
                      .manual_seed(t.numel()))
    tok = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    runs = []
    for c in (cfg, plain):
        reset_launches()
        lg, cache = M.forward(params, c, tok, mode="prefill", cache_len=44)
        outs = [lg[:, -1]]
        nxt = lg[:, -1:].argmax(-1)
        for _ in range(3):
            lg, cache = M.decode_step(params, c, nxt, cache)
            outs.append(lg[:, 0])
            nxt = lg[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        runs.append((outs, leaves(cache["segments"]),
                     launch_counts()["flash_attention_fwd"]))
    (got, got_c, n), (want, want_c, n_plain) = runs
    assert n == cfg.num_layers and n_plain == 0
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    for a, b in zip(got, want):
        assert rel(a, b) <= 1e-4
    for a, b in zip(got_c, want_c):
        assert rel(a, b) <= 1e-4


@pytest.mark.parametrize("s", [1024, 2048])
def test_mlstm_chunked_matches_quadratic_at_full_width(cuda, s):
    """One mLSTM block of xLSTM-350M at full width (d 1,024, 4 heads of
    512) in float32 on the card, 2 x S: the chunkwise form (chunk 256)
    against the quadratic form, outputs and final (C, n, m), within 1e-4
    relative (float32 sums in another order)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("xlstm-350m"), dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(s)
    p = L.init_mlstm(gen, cfg, torch.float32)
    x = torch.randn((2, s, cfg.d_model), generator=gen, device=cuda)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    with torch.no_grad():
        _, q, k, v, li, lf = L.mlstm_inputs(p, x, cfg)
        par, par_st = L.mlstm_parallel(q, k, v, li, lf, return_state=True)
        chk, chk_st = L.mlstm_chunked(q, k, v, li, lf, 256)
    assert rel(chk, par) <= 1e-4
    for n in ("C", "n", "m"):
        assert rel(chk_st[n], par_st[n]) <= 1e-4, n


def test_remat_keeps_or_recomputes_the_flash_forward(cuda):
    """SmolLM's smoke config (float32, 4 layers) on the card: `lm_loss`'s
    gradients under remat "block" and "block_save_flash" equal the plain
    backward's, and the flash kernel launches once a layer without
    remat, twice under "block" and once under "block_save_flash"."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.tree import leaves, tree_map

    cfg = get_smoke_config("smollm-135m")
    params = M.init_params(cfg, 5, cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                        generator=gen)
    runs = []
    for remat in M.REMATS:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        reset_launches()
        loss = M.lm_loss(live, dataclasses.replace(cfg, remat=remat), tok,
                         tok.roll(-1, 1))
        grads = torch.autograd.grad(loss, leaves(live))
        torch.cuda.synchronize()
        runs.append((loss, grads, launch_counts()["flash_attention_fwd"]))
    n = cfg.num_layers
    assert [r[2] for r in runs] == [n, 2 * n, n]
    for loss, grads, _ in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))
