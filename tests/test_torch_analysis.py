"""The port's work counts and roofline (`analysis.counts`,
`analysis.roofline`) against the reference's `repro.analysis`:
`active_params`, `model_flops` and `analytic_kernel_bytes` equal for
every architecture and shape; the dot FLOPs of the SmolLM-135M smoke
train step (2 x 64, float32) counted as the port's ops dispatch within
5 % of the reference's `flops_and_bytes` on its compiled HLO (the gap
printed: the port's flash backward is the plain pair schedule, the
reference's XLA's), and so are rank 0's of two smoke train steps placed
on a 2 x 2 mesh of a fake group against the reference's HLO on 4 host
devices, each exactly a quarter of its step on one device;
`collective_bytes` sees the all-reduce of a DTensor
matmul on a fake 4-rank group at its bytes; the H100 pricing."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.analysis import roofline as RR
from repro.analysis.hlo import flops_and_bytes as r_flops_and_bytes
from repro.configs import base as r_base
from repro.configs.registry import get_config as r_config
from repro.configs.registry import get_smoke_config as r_smoke
from repro.launch import steps as r_steps
from repro.models.model import abstract_params as r_abstract
from repro.optim.adamw import AdamWConfig as RAdamW
from repro.optim.adamw import abstract_state as r_abstract_state
from repro_torch.analysis import counts
from repro_torch.analysis import roofline as PR
from repro_torch.configs import base as cbase
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import steps as S
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state

HERE = os.path.dirname(os.path.abspath(__file__))
# the placed cells: attention split by (batch row, KV head) groups, and
# by heads
PLACED = ("smollm-135m", "command-r-35b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_arithmetic_equals_reference(arch):
    cfg, rcfg = get_config(arch), r_config(arch)
    n = PR.active_params(cfg)
    assert n == RR.active_params(rcfg)
    for shape, rshape in zip(cbase.ALL_SHAPES, r_base.ALL_SHAPES):
        assert PR.model_flops(cfg, shape, n) == \
            RR.model_flops(rcfg, rshape, n)
        for chips in (256, 512):
            assert PR.analytic_kernel_bytes(cfg, shape, chips) == \
                pytest.approx(RR.analytic_kernel_bytes(rcfg, rshape, chips),
                              rel=1e-12)


def test_smoke_train_step_flops_match_reference_hlo():
    b, s = 2, 64
    rcfg = r_smoke("smollm-135m")
    pa = r_abstract(rcfg)
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    hlo = jax.jit(r_steps.make_train_step(rcfg, RAdamW())).lower(
        pa, r_abstract_state(pa), tok, tok).compile().as_text()
    want = r_flops_and_bytes(hlo)["flops"]
    cfg = get_smoke_config("smollm-135m")
    p = init_params(cfg, 0, "cpu")
    tk = torch.zeros((b, s), dtype=torch.int32)
    _, got = counts.flops_and_bytes(S.make_train_step(cfg, AdamWConfig()),
                                    p, init_state(p), tk, tk)
    gap = got["flops"] / want - 1
    print(f"smoke train step dot FLOPs: port {got['flops']:.6e}, "
          f"reference HLO {want:.6e}, gap {gap:+.4%}")
    assert abs(gap) <= 0.05
    assert got["bytes"] > 0 and got["peak_bytes"] > 0
    assert got["collectives"] == {}


@functools.lru_cache(maxsize=None)
def _reference_placed(b: int, s: int) -> subprocess.Popen:
    """The reference's per-device dot FLOPs of `PLACED`'s train steps on
    a 2 x 2 mesh of host devices (tests/_torch_placed_flops_reference.py),
    started in a process of its own, which runs beside the port's
    counting."""
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_placed_flops_reference.py"),
         str(b), str(s), *PLACED], env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@functools.lru_cache(maxsize=None)
def _reference_placed_flops(b: int, s: int) -> dict:
    out, err = _reference_placed(b, s).communicate(timeout=300)
    assert _reference_placed(b, s).returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", PLACED)
def test_placed_train_step_flops_match_reference_hlo(arch):
    """Rank 0's dot FLOPs of the smoke train step (4 x 64, remat "block",
    as the dry run's train cells) placed by the plan on a 2 x 2 mesh of a
    fake group, as `launch.dryrun` counts a cell: a quarter of the same
    step's on one device (the plan splits every product and the
    attention evenly: SmolLM's 3 heads over the 2-wide TP axis by its
    (batch row, KV head) groups, Command-R's 8 by heads), and within 5 %
    of the reference's HLO on the same mesh of 4 host devices."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_mesh

    b, s = 4, 64
    _reference_placed(b, s)
    cfg = dataclasses.replace(get_smoke_config(arch), remat="block")
    p = init_params(cfg, 0, "cpu")
    tk = torch.zeros((b, s), dtype=torch.int32)
    _, whole = counts.flops_and_bytes(S.make_train_step(cfg, AdamWConfig()),
                                      p, init_state(p), tk, tk)
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        _, got = count_step(cfg, cbase.ShapeConfig("t", "train", s, b),
                            make_mesh(2, 2))
    finally:
        dist.destroy_process_group()
    want = _reference_placed_flops(b, s)[arch]
    gap = got["flops"] / want - 1
    print(f"{arch} placed train step, rank 0's dot FLOPs: port "
          f"{got['flops']:.6e}, one device / 4 {whole['flops'] / 4:.6e}, "
          f"reference HLO {want:.6e}, gap {gap:+.4%}")
    assert got["flops"] == pytest.approx(whole["flops"] / 4, rel=1e-12)
    assert got["kernel_scope_flops"] == \
        pytest.approx(whole["kernel_scope_flops"] / 4, rel=1e-12)
    assert abs(gap) <= 0.05
    assert got["collectives"]["all-reduce"] > 0


def test_collective_bytes_of_a_fake_group_matmul():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh(1, 4)
        x = distribute_tensor(torch.ones(8, 32), mesh, [Replicate(), Shard(1)])
        w = distribute_tensor(torch.ones(32, 16), mesh,
                              [Replicate(), Shard(0)])
        with counts.collective_bytes() as got:
            y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
        assert tuple(y.shape) == (8, 16)
        assert got == {"all-reduce": 8 * 16 * 4}
        _, c = counts.flops_and_bytes(lambda: x @ w)
        assert c["flops"] == 2 * 8 * 16 * 32 / 4  # this rank's quarter
    finally:
        dist.destroy_process_group()


def test_h100_roofline_pricing():
    row = PR.wheel_kernel_roofline("k", 10, 3.35e9, 1e9)
    assert row["ideal_us"] == pytest.approx(1e3)
    assert row["dominant"] == "memory"
    assert "tpu_ideal_us" not in row
    assert (PR.PEAK_FLOPS, PR.HBM_BW, PR.LINK_BW) == (989e12, 3.35e12, 50e9)
    rec = {"arch": "smollm-135m", "shape": "train_4k", "multi_pod": False,
           "status": "OK", "n_devices": 256,
           "cost": {"flops": 989e12, "bytes_accessed": 0.0,
                    "kernel_scope_bytes": 0.0},
           "collectives": {"all-reduce": 25e9}}
    r = PR.roofline_row(rec)
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["t_collective_s"] == pytest.approx(1.0)
    assert PR.roofline_row({"status": "FAIL"}) is None
