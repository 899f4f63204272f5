"""The port's checkpoints (`repro_torch.ckpt.checkpoint`) and the trainer's
restart from them (`launch.train.run_plain` with ``--ckpt-dir`` and
``--fail-at``), on the CPU.

  * a round trip of float32, bfloat16 and int64 tensors and a host int,
    in the reference's layout (``step_XXXXXXXX/manifest.json`` and
    ``proc00000/arr_*.npy``), read back by the reference's `restore` too;
  * rotation (`keep`), the refusal of a shape or structure mismatch, and
    incomplete ``.tmp-*`` directories skipped and swept;
  * a checkpoint that the reference's `CheckpointManager` wrote for
    SmolLM's smoke config mid-run (params, AdamW state and the data
    pipeline's position) restored through `models.convert` equal to the
    reference's state at that step;
  * `run_plain` with a checkpoint every 2 steps and a failure injected at
    step 4 of 6: the losses of the steps it replays and runs after the
    restore, and its final parameters, equal an uninterrupted run's bit
    for bit.

Everything is written under pytest's `tmp_path`.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

import repro.ckpt.checkpoint as r_ckpt
from repro.configs.registry import get_smoke_config as r_smoke_config
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch import steps as r_steps
from repro.models.model import init_params as r_init_params
from repro.optim.adamw import AdamWConfig as RAdamWConfig
from repro.optim.adamw import init_state as r_init_state
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import train
from repro_torch.models.convert import (params_from_jax,
                                        train_state_from_checkpoint)
from repro_torch.tree import leaves


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with one_core():
        yield


def _tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 5, generator=g),
            "layers": [(torch.randn(4, generator=g).to(torch.bfloat16),
                        torch.arange(6, dtype=torch.int64).reshape(2, 3))],
            "count": 7}


def _assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_round_trip_in_the_reference_layout(tmp_path):
    tree = _tree()
    final = ckpt.save(str(tmp_path), 12, tree, {"data": {"step": 13}})
    assert os.path.basename(final) == "step_00000012"
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    assert [m["name"] for m in man["leaves"]] == [
        "count", "layers/0/0", "layers/0/1", "w"]
    assert [m["dtype"] for m in man["leaves"]] == [
        "int32", "bfloat16", "int64", "float32"]
    assert sorted(os.listdir(os.path.join(final, "proc00000"))) == [
        f"arr_{i:05d}.npy" for i in range(4)]
    assert ckpt.latest_step(str(tmp_path)) == 12
    got, extra = ckpt.restore(str(tmp_path), 12, _tree(seed=1))
    _assert_same(got, tree)
    assert extra == {"data": {"step": 13}}
    # the reference reads the port's files (a tree without bfloat16: the
    # reference's own restore cannot cast its 2-byte records)
    plain = {"w": tree["w"], "count": 7, "layers": [(tree["layers"][0][1],)]}
    ckpt.save(str(tmp_path), 13, plain, {"data": {"step": 14}})
    target = {"w": jnp.zeros((3, 5)), "count": jnp.zeros((), jnp.int32),
              "layers": [(jnp.zeros((2, 3), jnp.int32),)]}
    rtree, rextra = r_ckpt.restore(str(tmp_path), 13, target)
    assert rextra == {"data": {"step": 14}} and int(rtree["count"]) == 7
    np.testing.assert_array_equal(np.asarray(rtree["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(rtree["layers"][0][0]),
                                  tree["layers"][0][1].numpy())


def test_reads_a_reference_bfloat16_leaf(tmp_path):
    w = jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)
    r_ckpt.save(str(tmp_path), 1, {"w": w})
    got, _ = ckpt.restore(str(tmp_path), 1,
                          {"w": torch.zeros(3, 4, dtype=torch.bfloat16)})
    want = np.asarray(w).view(np.uint16).astype(np.int32)
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy().view(np.uint16), want)


def test_manager_rotates_and_waits(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (2, 4, 6, 8):
        mgr.save_async(step, tree, {"data": {"step": step + 1}})
        saved = tree["w"].clone()
        tree["w"].add_(1.0)  # the saved copy was taken at save_async
    mgr.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000008"]
    step, got, extra = mgr.restore_latest(_tree(seed=2))
    assert step == 8 and extra == {"data": {"step": 9}}
    np.testing.assert_array_equal(got["w"].numpy(), saved.numpy())


def test_refuses_shape_and_structure_mismatch(tmp_path):
    ckpt.save(str(tmp_path), 3, _tree())
    bad = _tree()
    bad["w"] = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 3, bad)
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path), 3, {"w": torch.zeros(3, 5)})


def test_skips_and_sweeps_incomplete_saves(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree())
    # a save that crashed mid-way, newer than the complete one
    os.makedirs(tmp_path / "step_00000004.tmp-deadbeef" / "proc00000")
    os.makedirs(tmp_path / "step_00000005")  # no manifest: incomplete
    assert ckpt.latest_step(str(tmp_path)) == 2
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3)
    assert mgr.restore_latest(_tree())[0] == 2
    mgr.save_async(3, _tree())
    mgr.close()
    assert not any(".tmp-" in d for d in os.listdir(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference's CheckpointManager writes {"params", "opt"} and the
    data position after 3 SmolLM smoke steps; `train_state_from_checkpoint`
    gives the port's layout of exactly those values."""
    rcfg = r_smoke_config("smollm-135m")
    params = r_init_params(rcfg, jax.random.PRNGKey(0))
    opt = r_init_state(params)
    step_fn = jax.jit(r_steps.make_train_step(rcfg, RAdamWConfig(), "cosine",
                                              6))
    data = RSyntheticLM(RDataConfig(rcfg.vocab_size, 16, 2, seed=0))
    for _ in range(3):
        tokens, targets = data.next_batch()
        params, opt, _ = step_fn(params, opt, jnp.asarray(tokens),
                                 jnp.asarray(targets))
    mgr = r_ckpt.CheckpointManager(str(tmp_path), keep=3)
    mgr.save_async(2, {"params": params, "opt": opt},
                   {"data": data.state_dict()})
    deadline = time.monotonic() + 60
    while r_ckpt.latest_step(str(tmp_path)) != 2:
        assert time.monotonic() < deadline, "the reference's save never landed"
        time.sleep(0.05)
    cfg = get_smoke_config("smollm-135m")
    p, o, extra = train_state_from_checkpoint(str(tmp_path), 2, cfg)
    assert extra == {"data": {"step": 3}} and o["count"] == 3
    host = lambda t: jax.tree.map(np.asarray, t)
    for got, want in ((p, params), (o["m"], opt["m"]), (o["v"], opt["v"])):
        _assert_same(got, params_from_jax(host(want), cfg))
    # the port's own run_plain resumes from the converted state: its data
    # pipeline continues at batch 3
    d = train.build(train.parser().parse_args(
        ["--smoke", "--batch", "2", "--seq-len", "16"]))[2]
    d.load_state_dict(extra["data"])
    np.testing.assert_array_equal(d.next_batch()[0], data.next_batch()[0])


def _args(tmp_path, **kw):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq-len", "16", "--log-every", "100"]
    args = train.parser().parse_args(argv)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_run_plain_fail_at_resumes_to_the_same_run(tmp_path, capsys):
    plain = train.run_plain(_args(tmp_path))
    assert plain.steps == list(range(6))
    ck = str(tmp_path / "ck")
    res = train.run_plain(_args(tmp_path, ckpt_dir=ck, ckpt_every=2,
                                fail_at=4))
    # steps 0-3, the failure at 4, the restore of step 2, then 3-5 again
    assert res.steps == [0, 1, 2, 3, 3, 4, 5] and res.restored == [2]
    assert "injected failure" in capsys.readouterr().out
    by_step = dict(zip(res.steps, res.losses))
    assert res.losses[:4] == plain.losses[:4]
    assert [by_step[s] for s in (3, 4, 5)] == plain.losses[3:]
    _assert_same(res.params, plain.params)
    # the final state is on disk under the last step, and a rerun resumes
    # past the end: it runs nothing and restores the same parameters
    assert ckpt.latest_step(ck) == 5
    again = train.run_plain(_args(tmp_path, ckpt_dir=ck))
    assert again.steps == [] and again.restored == [5]
    _assert_same(again.params, plain.params)


def test_fail_at_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(RuntimeError, match="injected failure"):
        train.run_plain(_args(tmp_path, fail_at=1))
