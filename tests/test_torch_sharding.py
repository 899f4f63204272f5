"""The sharding plan's spec trees (`distributed.sharding`) against the
reference's `repro.distributed.sharding`, leaf for leaf, for all ten
architectures: parameters, `sanitize`d parameters and ZeRO-1
`opt_state_specs` on 16 x 16 and 2 x 16 x 16, `input_specs_for` (and
the sanitized decode caches) for each of `ALL_SHAPES`, and
`logits_spec`. The port keeps one tensor per period where the reference
stacks a segment's periods on a leading axis, so a port spec equals the
reference's with that axis dropped, period by period (the MTP block is
unstacked on both sides). Meshes are shape dicts (the reference's
functions read them as ``mesh.shape`` of a stand-in object). Also the reference's three unit cases, on the port.
"""
from __future__ import annotations

import dataclasses
import functools

import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import base as r_base
from repro.configs.registry import get_config as r_config
from repro.configs.registry import input_specs as r_input_specs
from repro.distributed import sharding as R
from repro.models.model import abstract_params as r_abstract
from repro_torch.configs import base as cbase
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config, input_specs)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models.model import abstract_params, init_params

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    return r_abstract(r_config(arch)), abstract_params(get_config(arch))


def _same(port, ref, stacked: bool, where: str = ""):
    """Port spec tree `port` against the reference's `ref`; `stacked`:
    the reference's leaves carry a leading periods axis here."""
    if isinstance(ref, JP):
        assert isinstance(port, P), where
        want = tuple(ref)[1:] if stacked else tuple(ref)
        assert tuple(port) == want, (where, port, ref)
        return
    if isinstance(ref, dict):
        assert set(port) == set(ref), (where, set(port) ^ set(ref))
        for k in ref:
            if k in ("segments", "enc_segments"):
                assert len(port[k]) == len(ref[k]), where
                for si, (pseg, rseg) in enumerate(zip(port[k], ref[k])):
                    for i, period in enumerate(pseg):
                        _same(period, rseg, True, f"{where}/{k}[{si}][{i}]")
            else:
                _same(port[k], ref[k], stacked, f"{where}/{k}")
        return
    assert isinstance(port, (list, tuple)) and len(port) == len(ref), where
    for i, (a, b) in enumerate(zip(port, ref)):
        _same(a, b, stacked, f"{where}[{i}]")


def _periods(arch: str) -> int:
    cfg = get_config(arch)
    return sum(n for _, n in cfg.segments() + cfg.enc_segments())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), r_config(arch)
    rp, pp = _trees(arch)
    _same(shd.param_specs(cfg), R.param_specs(rcfg), False, "params")
    for name, shape in MESHES.items():
        fm = FakeMesh(shape)
        rs = R.sanitize(R.param_specs(rcfg), rp, fm)
        ps = shd.sanitize(shd.param_specs(cfg), pp, shape)
        _same(ps, rs, False, f"sanitize {name}")
        _same(shd.opt_state_specs(ps, pp, shape),
              R.opt_state_specs(rs, rp, fm, zero1=True), False,
              f"zero1 {name}")
        for rshape, shape_cfg in zip(r_base.ALL_SHAPES, cbase.ALL_SHAPES):
            assert rshape.name == shape_cfg.name
            rin = R.input_specs_for(rcfg, rshape, fm)
            pin = shd.input_specs_for(cfg, shape_cfg, shape)
            _same(pin, rin, False, f"inputs {name} {rshape.name}")
            if rshape.kind == "decode":
                _same(shd.sanitize(pin["cache"],
                                   input_specs(cfg, shape_cfg)["cache"],
                                   shape),
                      R.sanitize(rin["cache"],
                                 r_input_specs(rcfg, rshape)["cache"], fm),
                      False, f"cache {name} {rshape.name}")
            b = rshape.global_batch
            assert tuple(shd.logits_spec(shape, b, cfg.vocab_size)) == \
                tuple(R.logits_spec(fm, b, rcfg.vocab_size))
        assert tuple(shd.logits_spec(shape, 7)) == \
            tuple(R.logits_spec(fm, 7))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_cover_structure(arch):
    """The spec tree's structure is the parameter tree's (one spec tree
    a period), every spec no longer than its leaf's rank."""
    cfg = get_config(arch)
    pp = _trees(arch)[1]

    def check(sp, leaf):
        assert isinstance(sp, P)
        assert len(sp) <= leaf.dim(), (sp, tuple(leaf.shape))
        return sp

    shd.spec_map(check, shd.param_specs(cfg), pp)
    assert sum(len(seg) for seg in shd.param_specs(cfg)["segments"]) + sum(
        len(seg) for seg in shd.param_specs(cfg).get("enc_segments", [])) \
        == _periods(arch)


def test_sanitize_drops_indivisible():
    specs = {"a": P(None, "model"), "b": P("model", None)}
    abs_tree = {"a": torch.empty((4, 2731), device="meta"),
                "b": torch.empty((256, 4), device="meta")}
    out = shd.sanitize(specs, abs_tree, {"model": 16, "data": 16})
    assert out["a"] == P(None, None)
    assert out["b"] == P("model", None)


def test_zero1_shards_largest_divisible_dim():
    pspecs = {"w": P(None, "model")}
    abs_tree = {"w": torch.empty((64, 128), device="meta")}
    out = shd.opt_state_specs(pspecs, abs_tree, {"model": 4, "data": 8},
                              zero1=True)
    assert out["m"]["w"] == P("data", "model")
    assert out["count"] == P()


def test_spec_type_and_abstract_params():
    assert P(None, "model") == P(None, "model") != P("model", None)
    assert P() == P() and repr(P("data")) == "P('data',)"
    assert hash(P("a")) == hash(P("a"))
    # the meta tree is the real init's, shape and dtype, leaf for leaf
    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"),
                              dtype="bfloat16")
    real = init_params(cfg, 0, "cpu")
    meta = abstract_params(cfg)
    shd.spec_map(lambda _, a, b: (a.shape == b.shape and a.dtype == b.dtype
                                  and b.device.type == "meta") or
                 pytest.fail(f"{a.shape} {b.shape}"),
                 shd.param_specs(cfg), real, meta)


def test_mesh_shape_dicts():
    assert shd.mesh_sizes({"data": 2, "model": 4}) == {"data": 2, "model": 4}
    assert shd.batch_axes(MESHES["2x16x16"]) == ("pod", "data")
    assert tuple(shd.input_specs_for(
        get_config("smollm-135m"), cbase.LONG_500K,
        MESHES["16x16"])["token"]) == (None, None)
