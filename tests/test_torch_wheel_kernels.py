"""The port's four wheel kernels against the reference's.

On the CPU each kernel's plain PyTorch version (`*_reference`, also what
the wrapper runs for a CPU tensor) is held against the JAX module's XLA
reference AND its Pallas kernel in interpret mode, at the small shapes
of tests/test_kernels.py. The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py. Every
comparison in this file is exact (tolerance 0): the kernels are integer
code.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import addressing as RA
from repro.engine import protocol as RP
from repro.engine.problems import get_problem as r_problem
from repro.kernels.wheel._common import in_segment as r_in_segment
from repro.kernels.wheel.descent import descent_reference as r_descent
from repro.kernels.wheel.descent import descent_tail_kernel
from repro.kernels.wheel.due_dedup import due_dedup_kernel
from repro.kernels.wheel.due_dedup import due_dedup_reference as r_dedup
from repro.kernels.wheel.enqueue import stage_rows_kernel
from repro.kernels.wheel.enqueue import stage_rows_reference as r_stage
from repro.kernels.wheel.threshold_step import threshold_step_kernel
from repro_torch.engine.problems import Majority
from repro_torch.kernels.wheel import (descent_tail, due_dedup, stage_rows,
                                       threshold_step)

pytestmark = pytest.mark.pallas

# the JAX references, jitted whole (one compile instead of one per op)
_r_threshold = jax.jit(lambda i, o, x: RP.threshold_rules(
    r_problem("majority"), jnp, i, o, x))
_r_dedup = jax.jit(r_dedup, static_argnames="nl")
_r_stage = jax.jit(r_stage, static_argnums=5)
_r_descent = jax.jit(r_descent, static_argnames="d")


def _eq(got, want, msg=""):
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    if w.dtype == np.bool_ or g.dtype == np.bool_:
        np.testing.assert_array_equal(g.astype(bool), w.astype(bool), msg)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      msg)


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.bool if a.dtype == np.bool_ else torch.int64
    return torch.from_numpy(np.array(a)).to(dtype)


# -- threshold_step -------------------------------------------------------

def _threshold_inputs(n, seed):
    rng = np.random.default_rng(seed)
    in_pay = rng.integers(-40, 41, (n, 3, 2)).astype(np.int32)
    out_pay = rng.integers(-40, 41, (n, 3, 2)).astype(np.int32)
    x = rng.integers(-300, 301, (n, 1)).astype(np.int32)
    return in_pay, out_pay, x


@pytest.mark.parametrize("n", [8, 100, 2048 + 17])
def test_threshold_step_plain_matches_jax(n):
    in_pay, out_pay, x = _threshold_inputs(n, n * 7 + 1)
    want_ref = _r_threshold(*map(jnp.asarray, (in_pay, out_pay, x)))
    want_pl = threshold_step_kernel(r_problem("majority"),
                                    *map(jnp.asarray, (in_pay, out_pay, x)),
                                    block=256, interpret=True)
    got = threshold_step(Majority(), *map(torch.from_numpy,
                                          (in_pay, out_pay, x)))
    for g, wr, wp, name in zip(got, want_ref, want_pl, ("viol", "out", "pay")):
        _eq(g, wr, f"{name} vs reference")
        _eq(g, wp, f"{name} vs Pallas")


# -- due_dedup ------------------------------------------------------------

def _dedup_inputs(ww, nl, seed, alert_frac=0.2):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, nl, ww).astype(np.int32)
    acc = rng.random(ww) < 0.6
    is_alert = rng.random(ww) < alert_frac
    w_seq = rng.integers(0, 50, ww).astype(np.int32)
    link_seq = rng.integers(0, 50, ww).astype(np.int32)
    return flat, acc & ~is_alert, acc & is_alert, w_seq, link_seq


def _dedup_torch(args):
    flat, acc_d, acc_a, w_seq, link_seq = args
    return (_t(flat), _t(acc_d), _t(acc_a), _t(w_seq, torch.int32),
            _t(link_seq, torch.int32))


@pytest.mark.parametrize("ww,block", [(64, 64), (100, 32), (576, 512),
                                      (576, 128)])
@pytest.mark.parametrize("seed", [0, 3])
def test_due_dedup_plain_matches_jax(ww, block, seed):
    nl = max(ww // 3, 3) * 3  # few links: heavy collisions
    args = _dedup_inputs(ww, nl, seed)
    want_ref = _r_dedup(*map(jnp.asarray, args), nl=nl)
    want_pl = due_dedup_kernel(*map(jnp.asarray, args), block=block,
                               interpret=True)
    got = due_dedup(*_dedup_torch(args), nl=nl)
    names = ("winner", "loser", "fresh", "alert_write", "is_rep", "aforce")
    for g, wr, wp, name in zip(got, want_ref, want_pl, names):
        _eq(g, wr, f"{name} vs reference")
        _eq(g, wp, f"{name} vs Pallas")


def test_due_dedup_no_alerts_plain_matches_jax():
    ww, nl = 128, 24
    flat, acc_d, _, w_seq, link_seq = _dedup_inputs(ww, nl, 11, alert_frac=0)
    args = (flat, acc_d, np.zeros(ww, bool), w_seq, link_seq)
    want = _r_dedup(*map(jnp.asarray, args), nl=nl)
    got = due_dedup(*_dedup_torch(args), nl=nl)
    for g, w in zip(got, want):
        _eq(g, w)
    assert not got[3].any()


# -- stage_rows -----------------------------------------------------------

def _stage_inputs(m, roww, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, (m, roww), dtype=np.uint64).astype(np.uint32)
    alert = rng.random(m) < 0.15
    mask = rng.random(m) < 0.6
    ordinal = np.cumsum(mask.astype(np.int32)) - 1  # -1 before the first
    perm = (rng.permutation(10) + 1).astype(np.int32)
    return rows, alert, ordinal, perm


@pytest.mark.parametrize("m,roww,t", [(2304, 8, 97), (2310, 9, 97),
                                     (40, 8, 0x7FFFFFFF - 3)])
def test_stage_rows_plain_matches_jax(m, roww, t):
    rows, alert, ordinal, perm = _stage_inputs(m, roww, m)
    dt_col = roww - 1
    jargs = (jnp.asarray(rows), jnp.asarray(alert), jnp.asarray(ordinal),
             jnp.asarray(perm), jnp.asarray(t, jnp.int32))
    want_ref = _r_stage(*jargs, dt_col)
    want_pl = stage_rows_kernel(*jargs, dt_col, interpret=True)
    t32 = torch.from_numpy(np.asarray([t], np.uint32).view(np.int32))
    got = stage_rows(_t(rows), _t(alert), _t(ordinal),
                     _t(perm[None], torch.int32), t32, dt_col)
    _eq(got, want_ref, "vs reference")
    _eq(got, want_pl, "vs Pallas")


# -- descent_tail ---------------------------------------------------------

def _descent_inputs(m, seed=0, d=16, n=64):
    """Routing-consistent rows from a real ring's owner tables."""
    rng = np.random.default_rng(seed)
    addrs = RA.random_ring(n, d, seed=seed + 1).astype(np.uint32)
    prev = np.roll(addrs, 1)
    pos = RA.position_from_segment(prev, addrs, d)
    dest = rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.uint32)
    origin = addrs[rng.integers(0, n, m)]
    own = np.searchsorted(addrs, dest, side="left") % n
    a_prev, a_self = prev[own], addrs[own]
    return dict(
        origin=origin, dest=dest,
        edge=rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.uint32),
        has_edge=rng.random(m) < 0.7, live=rng.random(m) < 0.8,
        entry=rng.random(m) < 0.5, pos_i=pos[own], a_prev=a_prev,
        a_self=a_self,
        self_seg=np.asarray(r_in_segment(jnp.asarray(origin),
                                         jnp.asarray(a_prev),
                                         jnp.asarray(a_self))),
        max_addr=np.asarray([addrs[-1]], np.uint32)), d


@pytest.mark.parametrize("m,block", [(64, 64), (200, 64)])
def test_descent_tail_plain_matches_jax(m, block):
    kw, d = _descent_inputs(m, seed=m)
    names = list(kw)
    jargs = [jnp.asarray(kw[k]) for k in names[:-1]] + [
        jnp.asarray(kw["max_addr"][0])]
    want_ref = _r_descent(*jargs, d=d)
    want_pl = descent_tail_kernel(*jargs, d=d, block=block, interpret=True)
    got = descent_tail(*(_t(kw[k]) for k in names), d=d)
    for g, wr, wp, name in zip(got, want_ref, want_pl,
                               ("acc", "drop", "o_dest", "o_edge", "o_he")):
        _eq(g, wr, f"{name} vs reference")
        _eq(g, wp, f"{name} vs Pallas")
