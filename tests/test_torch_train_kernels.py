"""The training substrate's kernels, plain versions against the
reference, on the CPU.

`threshold_gate`, the RG-LRU scan and gates, and the FA2 pair schedule
of the port (what the wrappers run for a CPU tensor) are held against
the JAX package's plain references AND its Pallas kernels in interpret
mode, on seeded numpy inputs; the gradients of the port's `linear_scan`
and `flash_attention` against `jax.vjp` of the reference's. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances: `threshold_gate` exact (an add, a compare and a subtract,
each rounded once in both); float32 scans and attention 2e-5 to 1e-4
absolute (sums and exponentials in another order: the port's scan
doubles, the reference's is chunked-associative or sequential; the
pair schedule's blocks differ from the Pallas kernel's tiles).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as r_flash_kernel
from repro.kernels.flash_attention.ref import mha_reference as r_mha
from repro.kernels.flash_attention.xla_ref import flash_attention_xla
from repro.kernels.rglru.ops import linear_scan as r_linear_scan
from repro.kernels.rglru.ref import linear_scan_reference as r_scan_ref
from repro.kernels.rglru.ref import rglru_gates as r_gates
from repro.kernels.rglru.rglru import rglru_scan as r_scan_kernel
from repro.kernels.threshold_gate.ref import threshold_gate_reference as r_gate
from repro.kernels.threshold_gate.threshold_gate import threshold_gate_kernel
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 mha_reference, pair_fwd)
from repro_torch.kernels.rglru import (linear_scan, linear_scan_reference,
                                       rglru_gates, rglru_scan)
from repro_torch.kernels.threshold_gate import (threshold_gate,
                                                threshold_gate_reference)

pytestmark = pytest.mark.pallas

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# -- threshold_gate ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(64,), (1000,), (128, 257), (3, 5, 7),
                                   (70000,)])
@pytest.mark.parametrize("tau", [0.0, 0.1, 2.0])
def test_threshold_gate_plain_matches_reference_and_pallas(shape, tau):
    rng = np.random.default_rng(sum(shape) + int(10 * tau))
    g = rng.standard_normal(shape).astype(np.float32)
    r = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    g.reshape(-1)[:3] = [0.0, tau, -tau]  # |acc| == tau ties
    r.reshape(-1)[:3] = 0.0
    want = r_gate(jnp.asarray(g), jnp.asarray(r), jnp.float32(tau))
    pallas = threshold_gate_kernel(jnp.asarray(g), jnp.asarray(r),
                                   jnp.float32(tau), block=4096,
                                   interpret=True)
    plain = threshold_gate_reference(T(g), T(r), tau)
    wrapped = threshold_gate(T(g), T(r), tau)  # CPU tensor: the plain version
    for got in (plain, wrapped):
        for x, w, p in zip(got[:2], want[:2], pallas[:2]):
            assert x.dtype == torch.float32 and x.shape == shape
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))
            np.testing.assert_array_equal(x.numpy(), np.asarray(p))
        assert got[2].dtype == torch.int32
        assert int(got[2]) == int(want[2]) == int(pallas[2])


def test_threshold_gate_bf16_grad_keeps_dtypes():
    rng = np.random.default_rng(3)
    g = rng.standard_normal(999).astype(np.float32)
    r = (rng.standard_normal(999) * 0.3).astype(np.float32)
    want = r_gate(jnp.asarray(g, jnp.bfloat16), jnp.asarray(r),
                  jnp.float32(0.5))
    got = threshold_gate_reference(T(g).bfloat16(), T(r), 0.5)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0], np.float32))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


# -- RG-LRU scan and gates -----------------------------------------------

SCAN_CASES = [(2, 64, 128, True), (1, 256, 256, False), (2, 100, 96, True),
              (3, 17, 8, False)]


@pytest.mark.parametrize("b,t,w,with_h0", SCAN_CASES)
def test_scan_plain_matches_reference_and_pallas(b, t, w, with_h0):
    rng = np.random.default_rng(b * t + w)
    a = rng.uniform(0.7, 0.999, (b, t, w)).astype(np.float32)
    u = (rng.standard_normal((b, t, w)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, w)) * 0.1).astype(np.float32) \
        if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = r_scan_ref(jnp.asarray(a), jnp.asarray(u), jh0)
    pallas = r_scan_kernel(jnp.asarray(a), jnp.asarray(u), jh0,
                           interpret=True)
    th0 = None if h0 is None else T(h0)
    for got in (linear_scan_reference(T(a), T(u), th0),
                rglru_scan(T(a), T(u), th0)):
        for x, w_, p in zip(got, want, pallas):
            np.testing.assert_allclose(_np(x), np.asarray(w_), atol=2e-5)
            np.testing.assert_allclose(_np(x), np.asarray(p), atol=2e-5)


@pytest.mark.parametrize("b,t,w,with_h0", SCAN_CASES)
def test_scan_reverse_plain_matches_flip_form(b, t, w, with_h0):
    """The reverse plain scan (what the backward runs) equals the forward
    scan of the time-flipped inputs, flipped back, exactly (the same sums
    in the same order), and the reference's scan of the flipped inputs
    within the forward tolerance; the CPU wrapper takes it."""
    rng = np.random.default_rng(b * t + w + 1)
    a = rng.uniform(0.7, 0.999, (b, t, w)).astype(np.float32)
    u = (rng.standard_normal((b, t, w)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, w)) * 0.1).astype(np.float32) \
        if with_h0 else None
    th0 = None if h0 is None else T(h0)
    got = linear_scan_reference(T(a), T(u), th0, reverse=True)
    flip = linear_scan_reference(T(a).flip(1), T(u).flip(1), th0)
    torch.testing.assert_close(got[0], flip[0].flip(1), atol=0, rtol=0)
    torch.testing.assert_close(got[1], flip[1], atol=0, rtol=0)
    want = r_scan_ref(jnp.asarray(a[:, ::-1]), jnp.asarray(u[:, ::-1]),
                      None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0])[:, ::-1],
                               atol=2e-5)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=2e-5)
    for x, y in zip(rglru_scan(T(a), T(u), th0, reverse=True), got):
        assert torch.equal(x, y)


def test_rglru_gates_match_reference():
    rng = np.random.default_rng(4)
    x, r, i = (rng.standard_normal((2, 9, 16)).astype(np.float32)
               for _ in range(3))
    lam = rng.uniform(2.2, 6.9, 16).astype(np.float32)
    want = r_gates(*map(jnp.asarray, (x, r, i, lam)), 8.0)
    got = rglru_gates(T(x), T(r), T(i), T(lam), 8.0)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_linear_scan_gradients_match_jax_vjp(use_kernel):
    """da, du, dh0 of the port's Function (its reversed-scan backward, on
    the CPU through the plain scan) against jax.vjp of the reference's
    custom-VJP `linear_scan`."""
    rng = np.random.default_rng(7)
    b, t, w = 2, 45, 24
    a = rng.uniform(0.5, 0.99, (b, t, w)).astype(np.float32)
    u = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    gh = rng.standard_normal((b, t, w)).astype(np.float32)
    gl = rng.standard_normal((b, w)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: r_linear_scan(*x, use_kernel),
                     *map(jnp.asarray, (a, u, h0)))
    want = vjp((jnp.asarray(gh), jnp.asarray(gl)))
    xs = [T(x).requires_grad_() for x in (a, u, h0)]
    h, hl = linear_scan(*xs, use_kernel=use_kernel)
    torch.autograd.backward((h, hl), (T(gh), T(gl)))
    for x, w_ in zip(xs, want):
        np.testing.assert_allclose(_np(x.grad), np.asarray(w_), atol=1e-4,
                                   rtol=1e-4)


# -- flash attention -------------------------------------------------------

FLASH_CASES = [
    # b, hq, hkv, sq, skv, dh, causal, window, q_offset
    (1, 4, 4, 128, 128, 64, True, None, 0),
    (2, 9, 3, 128, 128, 16, True, None, 0),     # GQA 9/3 (SmolLM's groups)
    (1, 4, 1, 256, 256, 32, True, 96, 0),       # MQA band (RG-9B's form)
    (2, 8, 2, 128, 256, 64, True, None, 0),     # Sq < Skv
    (1, 4, 2, 128, 256, 32, True, 64, 128),     # q_offset > 0
    (2, 4, 4, 128, 128, 32, False, None, 0),    # bidirectional
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_fwd_matches_reference_and_pallas(case):
    b, hq, hkv, sq, skv, dh, causal, window, off = case
    rng = np.random.default_rng(sq + dh + hq)
    q = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = r_mha(jq, jk, jv, causal=causal, window=window, q_offset=off)
    pallas = r_flash_kernel(jq, jk, jv, causal=causal, window=window,
                            q_offset=off, block_q=64, block_k=64,
                            interpret=True)
    o, lse = pair_fwd(T(q), T(k), T(v), causal, window, None, off)
    o2, lse2 = flash_attention_fwd(T(q), T(k), T(v), causal, window, None, off)
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(
        mha_reference(T(q), T(k), T(v), causal, window, None, off).numpy(),
        np.asarray(want), atol=2e-5)
    # lse: the log of the softmax denominator, from the reference's scores
    s = np.einsum("bhgqd,bhkd->bhgqk",
                  q.reshape(b, hkv, hq // hkv, sq, dh), k) * dh ** -0.5
    qpos = off + np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    vis = np.ones((sq, skv), bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= kpos > qpos - window
    s = np.where(vis, s.astype(np.float64), -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(b, hq, sq),
                               atol=2e-5)


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[2]])
def test_flash_gradients_match_jax_vjp(case):
    """dq, dk, dv of the port's `flash_attention` (its plain FA2 pair
    backward from the saved o and lse) against jax.vjp of the
    reference's `flash_attention_xla`."""
    b, hq, hkv, sq, skv, dh, causal, window, off = case
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    go = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: flash_attention_xla(*x, causal, window),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(go))
    xs = [T(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*xs, causal, window).backward(T(go))
    for x, w_ in zip(xs, want):
        np.testing.assert_allclose(_np(x.grad), np.asarray(w_), atol=1e-4,
                                   rtol=1e-4)
