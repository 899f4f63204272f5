"""The port's problem layer and its threshold kernels' plain versions
against the reference's, on the CPU.

`repro_torch.engine.problems` (majority, mean, L2) and the plain
versions of `threshold_step` (all three forms) and `majority_step` —
what the wrappers run for a CPU tensor — are held against the JAX
package's `protocol.threshold_rules` / `majority_step_reference` AND its
Pallas kernels in interpret mode, on seeded numpy inputs: int32
extremes that wrap for the mean problem, D in {1, 2, 3} and the general
CUDA kernel's shapes (D = 9, M = 18; D = 16, M = 32 and 1,024) with
forced argmax ties for L2. The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py. Every comparison is
exact (tolerance 0): integer results, and float32 margins computed in
the reference's operation order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.engine import problems as RPB
from repro.engine import protocol as RP
from repro.kernels.majority_step.majority_step import majority_step_kernel
from repro.kernels.majority_step.ref import \
    majority_step_reference as r_majority_step
from repro.kernels.wheel.threshold_step import threshold_step_kernel
from repro_torch.engine import problems as TPB
from repro_torch.kernels.majority_step import (majority_step,
                                               majority_step_reference)
from repro_torch.kernels.wheel import threshold_step, threshold_step_reference

pytestmark = pytest.mark.pallas

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _eq(got, want, msg=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == np.bool_ or g.dtype == np.bool_:
        np.testing.assert_array_equal(g.astype(bool), w.astype(bool), msg)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      msg)


def _check_threshold(port, ref, in_pay, out_pay, x, block=64):
    """Port plain version and wrapper (CPU) vs the reference's jnp rules
    and its Pallas kernel in interpret mode."""
    args_j = tuple(map(jnp.asarray, (in_pay, out_pay, x)))
    want_ref = jax.jit(lambda i, o, v: RP.threshold_rules(ref, jnp, i, o, v))(
        *args_j)
    want_pl = threshold_step_kernel(ref, *args_j, block=block, interpret=True)
    args_t = tuple(map(torch.from_numpy, (in_pay, out_pay, x)))
    plain = threshold_step_reference(port, *args_t)
    wrapped = threshold_step(port, *args_t)
    for i, name in enumerate(("viol", "out", "pay")):
        assert plain[i].dtype == (torch.bool if i == 0 else torch.int32)
        _eq(plain[i], want_ref[i], f"{name} vs reference")
        _eq(plain[i], want_pl[i], f"{name} vs Pallas")
        _eq(wrapped[i], plain[i], f"{name}: wrapper on the CPU")


# -- mean -------------------------------------------------------------------

@pytest.mark.parametrize("tau,n", [(0.3, 100), (-1.7, 257), (1e6, 64)])
def test_mean_threshold_matches_reference(tau, n):
    """Golden-like sums plus int32 extremes: sums and T * count wrap in
    int32 exactly as the reference's device arithmetic does."""
    rng = np.random.default_rng(n)
    port, ref = TPB.MeanMonitor(tau=tau), RPB.MeanMonitor(tau=tau)
    assert port.T == ref.T
    in_pay = rng.integers(-40_000, 40_001, (n, 3, 2)).astype(np.int32)
    out_pay = rng.integers(-40_000, 40_001, (n, 3, 2)).astype(np.int32)
    x = rng.integers(-300, 301, (n, 1)).astype(np.int32)
    ext = np.array([I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1, 0, -1],
                   np.int32)
    m = n // 4  # a quarter of the rows at the int32 edges
    in_pay[:m] = rng.choice(ext, (m, 3, 2))
    out_pay[:m] = rng.choice(ext, (m, 3, 2))
    x[:m] = rng.choice(ext, (m, 1))
    _check_threshold(port, ref, in_pay, out_pay, x)


# -- L2 ---------------------------------------------------------------------

def _l2_inputs(n, dim, seed, scale=256):
    """Payloads near the tau = 1 sphere, plus rows that force argmax ties:
    a zero vector sum (every half-space ties) and, for D >= 2, sums equal
    on two axes (the +e0/+e1 cover directions tie)."""
    rng = np.random.default_rng(seed)
    in_pay = np.empty((n, 3, dim + 1), np.int32)
    out_pay = np.empty((n, 3, dim + 1), np.int32)
    in_pay[..., :dim] = rng.integers(-3 * scale, 3 * scale + 1, (n, 3, dim))
    out_pay[..., :dim] = rng.integers(-3 * scale, 3 * scale + 1, (n, 3, dim))
    in_pay[..., dim] = rng.integers(0, 4, (n, 3))
    out_pay[..., dim] = rng.integers(0, 4, (n, 3))
    x = rng.integers(-2 * scale, 2 * scale + 1, (n, dim)).astype(np.int32)
    q = n // 4
    # K's vector sum is zero: all M projections equal -Tf * count
    in_pay[:q, :, :dim] = 0
    x[:q] = 0
    out_pay[:q // 2, :, :dim] = 0
    if dim >= 2:
        # K = (a, a, 0, ...): the +e0 and +e1 projections tie
        in_pay[q:2 * q, :, :dim] = 0
        a = rng.integers(1, 4 * scale, q)
        x[q:2 * q] = 0
        x[q:2 * q, 0] = a
        x[q:2 * q, 1] = a
    return in_pay, out_pay, x


@pytest.mark.parametrize("dim,ndirs", [
    (1, 16), (2, 16), (3, 16), (3, 6),
    # the shapes of the general CUDA kernel: D = 9 with its default cover,
    # D = 16 with its default cover and with a 16,384-float cover
    (9, 18), (16, 32), (16, 1024)])
@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_l2_threshold_matches_reference(dim, ndirs, tau):
    port = TPB.L2Thresh(tau=tau, dim=dim, ndirs=ndirs)
    ref = RPB.L2Thresh(tau=tau, dim=dim, ndirs=ndirs)
    np.testing.assert_array_equal(port.U, ref.U)  # the same frozen cover
    assert port.Tf == ref.Tf
    _check_threshold(port, ref, *_l2_inputs(160, dim, 10 * dim + ndirs))


def test_l2_argmax_ties_pick_the_first_direction():
    """With every half-space tied the argmax is direction 0, as numpy's
    and torch's argmax take the first maximum."""
    port = TPB.L2Thresh(tau=0.0, dim=2)
    k = torch.zeros((4, 3), dtype=torch.int32)
    k[:, 2] = torch.tensor([0, 1, 5, 9], dtype=torch.int32)
    pk = port._proj(k)
    assert (pk == pk[:, :1]).all() and (pk.argmax(-1) == 0).all()


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_l2_margin_and_global_output_match_reference(dim):
    rng = np.random.default_rng(dim)
    port, ref = TPB.L2Thresh(dim=dim), RPB.L2Thresh(dim=dim)
    pay = rng.integers(-5000, 5001, (200, dim + 1)).astype(np.int32)
    want = np.asarray(ref.margin(jnp, jnp.asarray(pay)))
    got = port.margin(torch, torch.from_numpy(pay))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.margin(np, pay))
    for shift in (0.2, 0.9, 1.6):  # the mean inside, near and outside
        raw = rng.normal(shift / np.sqrt(dim), 0.5, (50, dim))
        data = port.init_state(raw)
        np.testing.assert_array_equal(data, ref.init_state(raw))
        assert port.global_output(data) == ref.global_output(data)


# -- the problem API -----------------------------------------------------------

def test_problem_api_matches_reference():
    assert sorted(TPB.PROBLEMS) == sorted(RPB.PROBLEMS)
    assert TPB.get_problem(None) is TPB.MAJORITY
    mean = TPB.get_problem("mean", tau=0.3)
    assert isinstance(mean, TPB.MeanMonitor) and mean.T == 77
    l2 = TPB.get_problem("l2", tau=2.0, dim=3, ndirs=12)
    assert (l2.data_width, l2.payload_width, l2.U.shape) == (3, 4, (12, 3))
    assert TPB.get_problem(l2) is l2
    with pytest.raises(ValueError, match="unknown threshold problem"):
        TPB.get_problem("median")
    rng = np.random.default_rng(0)
    raw = rng.normal(0.1, 0.8, 40)
    for p, r in ((TPB.MeanMonitor(0.3), RPB.MeanMonitor(0.3)),
                 (TPB.Majority(), RPB.Majority())):
        data = raw if p.name == "mean" else (raw > 0).astype(np.int64)
        np.testing.assert_array_equal(p.init_state(data), r.init_state(data))
        q = p.init_state(data)
        assert p.global_output(q) == r.global_output(q)
        np.testing.assert_array_equal(p.peer_data(data[3]), r.peer_data(data[3]))
    v = rng.normal(size=3)
    np.testing.assert_array_equal(l2.peer_data(v), RPB.L2Thresh(
        tau=2.0, dim=3, ndirs=12).peer_data(v))
    with pytest.raises(ValueError):
        TPB.L2Thresh(dim=2).init_state(np.zeros((4, 3)))
    with pytest.raises(ValueError):
        TPB.Majority().init_state(np.array([0, 2]))


# -- majority_step --------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 100, 4096 + 17])
def test_majority_step_matches_reference(n):
    rng = np.random.default_rng(n)
    planes = [rng.integers(-40, 41, (n, 3)).astype(np.int32)
              for _ in range(4)]
    x = rng.integers(0, 2, n).astype(np.int32)
    m = n // 8  # int32 edges: the sums wrap
    for p in planes:
        p[:m] = rng.choice(np.array([I32_MIN, I32_MAX, -1, 0], np.int32),
                           (m, 3))
    args_j = tuple(map(jnp.asarray, (*planes, x)))
    want_ref = r_majority_step(*args_j)
    want_pl = majority_step_kernel(*args_j, block=1024, interpret=True)
    args_t = tuple(map(torch.from_numpy, (*planes, x)))
    plain = majority_step_reference(*args_t)
    wrapped = majority_step(*args_t)
    names = ("viol", "out", "pay_ones", "pay_tot")
    for g, wr, wp, w2, name in zip(plain, want_ref, want_pl, wrapped, names):
        _eq(g, wr, f"{name} vs reference")
        _eq(g, wp, f"{name} vs Pallas")
        _eq(w2, g, f"{name}: wrapper on the CPU")
    assert plain[1].dtype == torch.int32 and plain[0].dtype == torch.bool
