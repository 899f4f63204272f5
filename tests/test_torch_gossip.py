"""The gossip baseline (`distributed.gossip_sync`) against the
reference's `repro.distributed.gossip_sync` on the CPU: every round bit
for bit on float32 and bfloat16 trees with G = 2, 4, 8 and 16 pods over
more rounds than log2 G (the schedule wraps), `agreement_error` within
1e-6 relative (to the larger of its value and the tree's error before
the first round: once the pods agree, the error is float32 rounding
noise, ~1e-8, whose last digits follow the order of the mean's sum), and the reference's two properties
(tests/test_distributed.py: convergence to the mean in log2 G rounds,
the error never rising round to round)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import gossip_sync as R
from repro_torch.distributed.gossip_sync import agreement_error, gossip_round

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree(g: int, dtype: str, seed: int):
    """A reference tree and the port's, the same bits: two leaves with a
    leading pod axis of g."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    ref = {"w": jnp.asarray(rng.standard_normal((g, 5, 7)), jd),
           "b": [jnp.asarray(rng.standard_normal((g, 3)), jd)]}
    return ref, _port(ref, td)


def _port(ref, td):
    def one(a):
        a = np.asarray(a)
        if td == torch.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(td)
        return torch.from_numpy(a.copy())
    return {"w": one(ref["w"]), "b": [one(ref["b"][0])]}


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [2, 4, 8, 16])
def test_gossip_round_bit_identical(g, dtype):
    ref, port = _tree(g, dtype, seed=g)
    rounds = 2 * max(g.bit_length() - 1, 1) + 1
    e0 = float(R.agreement_error(ref))
    for r in range(rounds):
        ref = R.gossip_round(ref, r, g)
        port = gossip_round(port, r, g)
        for a, b in ((ref["w"], port["w"]), (ref["b"][0], port["b"][0])):
            assert b.dtype == DTYPES[dtype][1]
            np.testing.assert_array_equal(_bits(b), _ref_bits(a))
        want = float(R.agreement_error(ref))
        got = float(agreement_error(port))
        assert abs(got - want) <= 1e-6 * max(want, e0), (r, got, want)


def test_gossip_converges_to_mean():
    params = {"w": torch.arange(8.0)[:, None] * torch.ones((8, 4))}
    e0 = float(agreement_error(params))
    p = params
    for r in range(3):  # log2(8) rounds of hypercube averaging
        p = gossip_round(p, r, 8)
    e1 = float(agreement_error(p))
    assert e1 < 1e-5 < e0
    np.testing.assert_allclose(p["w"][0].numpy(), 3.5, atol=1e-6)


def test_gossip_partial_rounds_reduce_error_monotonically():
    p = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 6)).astype(np.float32))}
    errs = [float(agreement_error(p))]
    for r in range(4):
        p = gossip_round(p, r, 16)
        errs.append(float(agreement_error(p)))
    assert all(b < a + 1e-9 for a, b in zip(errs, errs[1:]))


def test_gossip_needs_power_of_two_pods():
    with pytest.raises(ValueError, match="2\\^k pods"):
        gossip_round({"w": torch.zeros((3, 2))}, 0, 3)
