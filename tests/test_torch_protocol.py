"""The port's Alg. 1 / Alg. 3 rules against the reference's.

`repro_torch.engine.protocol` on int64 addresses / int32 payloads vs
`repro.engine.protocol` on the device engine's arithmetic (wrapping
uint32 addresses, numpy; int32 payloads, jnp), on seeded grids built from real rings
(root, leaves, wrapped segment) plus the all-ones and zero edges, at
d = 32 and d = 16. Tolerance: exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import addressing as RA
from repro.engine import protocol as RP
from repro.engine import problems as RP_problems
from repro.engine.problems import Majority as RMajority
from repro_torch.engine import protocol as TP
from repro_torch.engine.problems import Majority, get_problem


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64 if a.dtype != np.bool_ else bool))


def _eq(got, want, msg=""):
    want = np.asarray(want)
    g = got.numpy()
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(g.astype(bool), want, err_msg=msg)
    else:
        np.testing.assert_array_equal(g.astype(np.int64),
                                      want.astype(np.int64), err_msg=msg)


def _tables(d: int, n: int, seed: int):
    """Sorted ring addresses with each peer's prev and position (uint32)."""
    addrs = RA.random_ring(n, d, seed=seed).astype(np.uint32)
    addrs[0] = 0  # a peer at address 0: the root owns a degenerate edge
    addrs = np.unique(addrs)
    prev = np.roll(addrs, 1)
    return addrs, prev, RA.position_from_segment(prev, addrs, d)


@pytest.mark.parametrize("d", [32, 16])
def test_send_fields_matches_reference(d):
    addrs, prev, pos = _tables(d, 300, seed=d)
    m = (1 << d) - 1
    pos = np.concatenate([pos, np.asarray([0, 1, m, 1 << (d - 1)], np.uint32)])
    addrs = np.concatenate([addrs, np.asarray([m, 5, 0, 7], np.uint32)])
    prev = np.concatenate([prev, np.asarray([m - 1, 3, m, 2], np.uint32)])
    for dr in range(3):
        dirs = np.full(pos.shape, dr, np.int32)
        want = RP.send_fields(np, pos, dirs, addrs, prev, d)
        got = TP.send_fields(_t(pos), torch.from_numpy(dirs), _t(addrs),
                             _t(prev), d)
        for g, w, name in zip(got, want, ("valid", "origin", "dest", "edge",
                                          "has_edge")):
            _eq(g, w, f"dir {dr} {name}")


@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("repair", [True, False])
def test_deliver_rules_matches_reference(d, repair):
    """Routing-consistent rows (owner tables of a real ring) plus random
    edges, entry flags and self-segment flags."""
    addrs, prev, pos = _tables(d, 200, seed=7 + d)
    rng = np.random.default_rng(d)
    k = 6000
    m = (1 << d) - 1
    dest = rng.integers(0, m + 1, k, dtype=np.uint64).astype(np.uint32)
    dest[:4] = [0, m, 1, 1 << (d - 1)]
    own = np.searchsorted(addrs, dest, side="left") % addrs.size
    # origins: real positions, plus the receiver's own (self-sends)
    origin = pos[rng.integers(0, pos.size, k)]
    origin[::17] = pos[own][::17]
    edge = np.where(rng.random(k) < 0.5, addrs[own], prev[own])
    edge[::5] = rng.integers(0, m + 1, edge[::5].size, dtype=np.uint64)
    kw = dict(origin=origin, dest=dest, edge=edge.astype(np.uint32),
              has_edge=rng.random(k) < 0.7, network_entry=rng.random(k) < 0.6,
              pos_i=pos[own], a_prev=prev[own], a_self=addrs[own],
              self_seg=rng.random(k) < 0.3,
              max_addr=np.asarray([addrs[-1]], np.uint32))
    want = RP.deliver_rules(np, d=d, repair=repair, **kw)
    got = TP.deliver_rules(d=d, repair=repair,
                           **{a: _t(v) for a, v in kw.items()})
    for g, w, name in zip(got, want, want._fields):
        _eq(g, w, name)


def test_threshold_and_majority_rules_match_reference():
    """int32 payload algebra, including values near the int32 edges
    (wrapping adds), through both the generic and the unpacked form."""
    rng = np.random.default_rng(5)
    n = 3000
    in_pay = rng.integers(-40, 41, (n, 3, 2)).astype(np.int32)
    out_pay = rng.integers(-40, 41, (n, 3, 2)).astype(np.int32)
    x = rng.integers(0, 2, (n, 1)).astype(np.int32)
    in_pay[:5] = np.iinfo(np.int32).max - 3
    out_pay[5:10] = np.iinfo(np.int32).min + 2
    want = jax.jit(lambda i, o, v: RP.threshold_rules(RMajority(), jnp, i, o, v))(
        jnp.asarray(in_pay), jnp.asarray(out_pay), jnp.asarray(x))
    ti, to, tx = map(torch.from_numpy, (in_pay, out_pay, x))
    got = TP.threshold_rules(Majority(), ti, to, tx)
    for g, w, name in zip(got, want, ("viol", "out", "pay")):
        assert g.dtype == (torch.bool if name == "viol" else torch.int32)
        _eq(g, w, name)
    wm = jax.jit(RP.majority_rules)(*(jnp.asarray(a) for a in (
        in_pay[..., 0], in_pay[..., 1], out_pay[..., 0], out_pay[..., 1],
        x[:, 0])))
    gm = TP.majority_rules(ti[..., 0], ti[..., 1], to[..., 0], to[..., 1],
                           tx[:, 0])
    for g, w in zip(gm, wm):
        _eq(g, w)
    _eq(gm[0], np.asarray(want[0]))


def test_problem_layer_scope():
    assert isinstance(get_problem(None), Majority)
    assert isinstance(get_problem("majority"), Majority)
    for name in ("mean", "l2"):  # ported: the reference's names resolve
        got, want = get_problem(name), RP_problems.get_problem(name)
        assert type(got).__name__ == type(want).__name__
        assert got.payload_width == want.payload_width
    with pytest.raises(ValueError):
        get_problem("nope")
    data = np.array([[1], [0], [1]])
    assert Majority().global_output(data) == RMajority().global_output(data)
