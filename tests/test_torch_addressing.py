"""The port's address algebra and hash against the reference's.

`repro_torch.core.addressing` keeps d-bit addresses in int64 tensors and
masks at every wrap; `repro.core.addressing` computes in wrapping uint32
(numpy) — the device engine's arithmetic. Every comparison is exact, on
seeded grids that include the root (0), leaves, ring wrap, the all-ones
address 0xFFFFFFFF and every power of two, at d = 32 and d = 16.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import addressing as RA
from repro.engine.jax_backend import _hash_delay, _hash_u32
from repro_torch.core import addressing as TA
from repro_torch.core.dht import Ring
from repro_torch.engine.torch_backend import hash_delay, hash_u32


def _grid(d: int, k: int, seed: int) -> np.ndarray:
    """Edge addresses plus seeded random ones, as uint32."""
    m = (1 << d) - 1
    edges = [0, 1, 2, 3, m, m - 1, m >> 1, (m >> 1) + 1]
    edges += [1 << b for b in range(d)] + [(1 << b) - 1 for b in range(1, d)]
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, m + 1, k, dtype=np.uint64)
    return np.concatenate([np.asarray(edges, np.uint64), rand]).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _eq(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    g = got.numpy()
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(g.astype(bool), want, err_msg=msg)
    else:
        np.testing.assert_array_equal(g, want.astype(np.int64), err_msg=msg)


@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("fn", ["lowbit", "up", "cw", "ccw", "is_leaf",
                                "highbit", "trailing_zeros", "popcount"])
def test_unary_matches_reference(fn, d):
    """Tolerance: exact. One-argument functions on the edge grid."""
    a = _grid(d, 400, seed=d)
    if fn in ("up", "cw", "ccw", "highbit", "trailing_zeros"):
        want = getattr(RA, fn)(a, d)
        got = getattr(TA, fn)(_t(a), d)
    else:
        want = getattr(RA, fn)(a)
        got = getattr(TA, fn)(_t(a))
    _eq(got, want, fn)


@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("fn", ["in_subtree", "is_foreparent",
                                "in_cw_subtree", "direction_of",
                                "position_from_segment"])
def test_binary_matches_reference(fn, d):
    """Tolerance: exact. All pairs of the edge grid plus random pairs."""
    g = _grid(d, 40, seed=3 * d)
    x, y = (a.ravel() for a in np.meshgrid(g, g))
    rng = np.random.default_rng(d + 1)
    m = (1 << d) - 1
    rx = rng.integers(0, m + 1, 4000, dtype=np.uint64).astype(np.uint32)
    ry = rng.integers(0, m + 1, 4000, dtype=np.uint64).astype(np.uint32)
    x, y = np.concatenate([x, rx]), np.concatenate([y, ry])
    want = getattr(RA, fn)(x, y, d)
    got = getattr(TA, fn)(_t(x), _t(y), d)
    _eq(got, want, fn)


def test_numpy_path_and_ring_match_reference():
    """The port's numpy path (uint64, what `Ring` uses) is the reference's."""
    addrs = RA.random_ring(500, 32, seed=9)
    np.testing.assert_array_equal(TA.random_ring(500, 32, seed=9), addrs)
    np.testing.assert_array_equal(TA.ring_positions(addrs, 32),
                                  RA.ring_positions(addrs, 32))
    ring = Ring(addrs, 32)
    np.testing.assert_array_equal(ring.positions(), RA.ring_positions(addrs, 32))
    _eq(TA.ring_positions(_t(addrs.astype(np.uint32)), 32),
        RA.ring_positions(addrs.astype(np.uint32), 32))
    assert TA.mask_of(32) == RA.mask_of(32) == 0xFFFFFFFF


def test_hash_wraps_like_uint32():
    """Tolerance: exact. The engine's integer mix at extreme operands
    (products of two 32-bit values overflow int64 unless split)."""
    ext = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                   np.uint32)
    rng = np.random.default_rng(0)
    idx = np.concatenate([ext, rng.integers(0, 2**32, 200, dtype=np.uint64)
                          .astype(np.uint32)])
    r_hash = jax.jit(_hash_u32)
    for t in (0, 7, 0x7FFFFFFF, 0xFFFFFFFF):
        for salt in (0, 0x12345678, 0xFFFFFFFF):
            want = r_hash(jnp.asarray(idx), jnp.asarray(np.uint32(t)),
                          jnp.asarray(np.uint32(salt)))
            _eq(hash_u32(_t(idx), t, salt), np.asarray(want), f"t={t}")
    small = np.arange(300, dtype=np.int32)
    want = jax.jit(_hash_delay)(jnp.asarray(small),
                                jnp.asarray(41, jnp.int32),
                                jnp.asarray(np.uint32(0xDEADBEEF)))
    _eq(hash_delay(torch.from_numpy(small).long(), 41, 0xDEADBEEF),
        np.asarray(want))
    # the per-cycle permutation index of the cycle body, host side
    for t in (0, 99, 0x7FFFFFFE):
        for salt in (0, 0xFFFFFFFF):
            h = ((jnp.asarray(t + 1, jnp.int32).astype(jnp.uint32)
                  * jnp.uint32(0x9E3779B1) + jnp.uint32(salt)) >> 28)
            assert (((t + 1) * 0x9E3779B1 + salt) & 0xFFFFFFFF) >> 28 == int(h)
