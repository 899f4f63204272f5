"""DeepSeek-V3's multi-token-prediction head (``cfg.mtp``, depth 1) and
MoE / MLA training in the port against the reference, on the CPU.

The DeepSeek-V3 and Arctic smoke configs, float32, start from one
tree in the reference's layout: the port's `init_params` at seed 0 (the
reference's structure and shapes, with ``mtp`` its ``"mtp"`` tree:
``proj``, ``norm_h``, ``norm_e`` and one block of the pattern's last
kind; asserted below. The reference's own init, jitted, costs ~22 s a
config on one core), every all-zero leaf (``router_bias``) then drawn
from N(0, 0.5^2) and every all-one leaf (the norms, ``norm_h`` /
``norm_e`` among them) from U[0.5, 1.5] (tests/test_torch_moe_mla.py's
`seeded_constant_leaves`), so that a swapped norm or an ignored bias
shows. The port gets them through `params_from_jax`.

  * `lm_loss` and the gradient of every leaf, with the head and without
    it (one jitted reference program an architecture computes both),
    against the reference's `value_and_grad`: the loss within
    1e-6 relative, each leaf within 1e-5 relative in L2
    (tests/test_torch_encdec.py's bounds); ``router_bias``'s gradient is
    zero on both sides (it only picks experts);
  * DeepSeek-V3's `run_plain` for 3 steps with the head against the
    reference's `run_plain` (its jitted step's outputs recorded, as
    tests/test_torch_train.py does; Arctic's training is held by the
    gradients above): losses 1e-5 and grad norms 1e-4
    relative, final parameters 1e-4 absolute; the reference's last
    checkpoint read back through `train_state_from_checkpoint`;
  * the conversions of the ``mtp`` tree both ways, and `forward`, which
    leaves the head unused;
  * a checkpoint the port writes (`train_state_to_numpy` through its
    `CheckpointManager`) read by the reference's `CheckpointManager`,
    bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_moe_mla import seeded_constant_leaves
from test_torch_one_core import one_core
from test_torch_train import _args, _run_reference

import jax
import jax.numpy as jnp

import repro.ckpt.checkpoint as r_ckpt
import repro.launch.train as r_train
from repro.configs import registry as r_registry
from repro.models import model as R
from repro.optim.adamw import init_state as r_init_state
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.models import model as M
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        train_state_from_checkpoint,
                                        train_state_to_numpy)
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.tree import leaves, tree_map, unflatten

ARCHS = ("deepseek-v3-671b", "arctic-480b")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core (tiny shapes; the thread pools
    of XLA and torch would otherwise spin on the other workers' cores)."""
    with one_core():
        yield


def configs(arch: str, mtp: bool = True):
    """(reference config, port config) of `arch`'s smoke model."""
    return tuple(dataclasses.replace(get(arch), mtp=mtp) for get in (
        r_registry.get_smoke_config, registry.get_smoke_config))


@functools.lru_cache(maxsize=None)
def _reference_tree(arch: str):
    _, cfg = configs(arch)
    tree = params_to_numpy(M.init_params(cfg, 0, "cpu"), cfg)
    return seeded_constant_leaves(tree, 5)


def reference_tree(arch: str, mtp: bool = True):
    """The reference's parameters (numpy) with the head or without it."""
    tree = dict(_reference_tree(arch))
    if not mtp:
        del tree["mtp"]
    return tree


def _batch(vocab: int, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tgt = np.concatenate([tok[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    tgt[0, :3] = -1  # masked targets inside the sequence too
    return tok, tgt


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch: str):
    """{mtp: (loss, gradients)} of the reference's `lm_loss` on
    `_batch`'s tokens, with the head and without, from one jitted
    program."""
    rcfgs = {m: configs(arch, m)[0] for m in (False, True)}
    tok, tgt = (jnp.asarray(a) for a in _batch(rcfgs[True].vocab_size, 2,
                                               16, 3))

    def both(p):
        head = dict(p)
        del head["mtp"]
        grad = lambda m, q: jax.value_and_grad(
            lambda q: R.lm_loss(q, rcfgs[m], tok, tgt))(q)
        return {True: grad(True, p), False: grad(False, head)}

    return jax.jit(both)(jax.tree.map(jnp.asarray, reference_tree(arch)))


@pytest.mark.parametrize("mtp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, mtp):
    _, cfg = configs(arch, mtp)
    tree = reference_tree(arch, mtp)
    tok, tgt = _batch(cfg.vocab_size, 2, 16, 3)
    want_loss, want_g = reference_loss_and_grads(arch)[mtp]
    params = params_from_jax(tree, cfg)
    assert ("mtp" in params) == mtp
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = M.lm_loss(live, cfg, torch.from_numpy(tok), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    # router_bias only picks experts: no gradient reaches it
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(live), grads)]
    named = jax.tree_util.tree_leaves_with_path(want_g)
    got_g = leaves(params_to_numpy(unflatten(params, grads), cfg))
    assert len(got_g) == len(named)
    for g, (path, w) in zip(got_g, named):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        if path[-1].key == "router_bias":
            assert not g.any() and not w.any(), path
        else:
            assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), path
    if mtp:  # the head's loss adds to the trunk's
        base = M.lm_loss(params, configs(arch, False)[1],
                         torch.from_numpy(tok), torch.from_numpy(tgt))
        assert loss.item() > base.item() + 1.0


def test_run_plain_with_mtp_matches_reference(monkeypatch, tmp_path):
    """DeepSeek-V3's smoke model, 3 steps of `run_plain` with the head
    from the same parameters (the reference's `init_params` is patched
    to return them) and the same `SyntheticLM` batches; then the
    reference's final checkpoint (its
    ``--ckpt-dir``) read into the port's layout equals the port's final
    state within the same bound."""
    arch = ARCHS[0]
    rcfg, cfg = configs(arch)
    tree = reference_tree(arch)
    monkeypatch.setattr(r_train, "get_smoke_config", lambda a: rcfg)
    monkeypatch.setattr(r_train, "init_params",
                        lambda c, key: jax.tree.map(jnp.asarray, tree))
    rdir = str(tmp_path / "ref")
    args = _args(arch=arch, steps=3, batch=2, seq_len=16, ckpt_dir=rdir,
                 ckpt_every=100)
    want_loss, (step_calls,) = _run_reference(monkeypatch, r_train.run_plain,
                                              args)
    args = _args(arch=arch, steps=3, batch=2, seq_len=16)
    res = train.run_plain(args, cfg=cfg, params=params_from_jax(tree, cfg))
    np.testing.assert_allclose(
        res.losses, [float(out[2]["loss"]) for out in step_calls], rtol=1e-5)
    np.testing.assert_allclose(res.loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(
        res.grad_norms, [float(out[2]["grad_norm"]) for out in step_calls],
        rtol=1e-4)
    got = leaves(params_to_numpy(res.params, cfg))
    want = jax.tree.leaves(step_calls[-1][0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
    p, opt, extra = train_state_from_checkpoint(rdir, 3, cfg)
    assert opt["count"] == 3 and extra == {"data": {"step": 3}}
    assert sorted(p["mtp"]) == ["block", "norm_e", "norm_h", "proj"]
    for g, w in zip(leaves(params_to_numpy(p, cfg)), got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_mtp_tree_converts_both_ways_and_forward_ignores_it(arch):
    """`params_from_jax` / `params_to_numpy` carry the ``mtp`` tree bit
    for bit in the reference's structure; the port's `init_params` makes
    the reference's shapes; `forward`'s logits and a prefill's are the
    same with the head as without it."""
    rcfg, cfg = configs(arch)
    tree = reference_tree(arch)
    params = params_from_jax(tree, cfg)
    blk = params["mtp"]["block"]
    assert isinstance(blk, dict) and "norm1" in blk and "ffn" in blk
    assert params["mtp"]["proj"].shape == (2 * cfg.d_model, cfg.d_model)
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    want = jax.eval_shape(lambda: R.init_params(rcfg, jax.random.PRNGKey(0)))
    mine = params_to_numpy(M.init_params(cfg, 0, "cpu"), cfg)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    assert [a.shape for a in leaves(mine)] == \
        [a.shape for a in jax.tree.leaves(want)]
    tok = torch.from_numpy(_batch(cfg.vocab_size, 2, 12, 4)[0])
    plain_cfg = configs(arch, False)[1]
    plain = params_from_jax(reference_tree(arch, False), plain_cfg)
    assert torch.equal(M.forward(params, cfg, tok),
                       M.forward(plain, plain_cfg, tok))
    lg, cache = steps.make_prefill_step(cfg, 16)(params, tok)
    lg0, cache0 = steps.make_prefill_step(plain_cfg, 16)(plain, tok)
    assert torch.equal(lg, lg0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(cache),
                                                 leaves(cache0)))


def test_port_checkpoint_with_mtp_reads_in_the_reference(tmp_path):
    """2 train steps of DeepSeek's smoke model with the head on the port;
    its parameters and AdamW state in the reference's layout
    (`train_state_to_numpy`) through the port's `CheckpointManager`; the
    reference's `CheckpointManager` restores them into its own
    ``{"params", "opt"}`` tree bit for bit, and the port's
    `train_state_from_checkpoint` restores its own state bit for bit."""
    arch = ARCHS[0]
    rcfg, cfg = configs(arch)
    tree = reference_tree(arch)
    params = params_from_jax(tree, cfg)
    opt = init_state(params)
    step = steps.make_train_step(cfg, AdamWConfig(), "cosine", 6)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=0))
    for _ in range(2):
        tokens, targets = (torch.from_numpy(b) for b in data.next_batch())
        params, opt, _ = step(params, opt, tokens, targets)
    state = train_state_to_numpy(params, opt, cfg)
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(1, state, {"data": data.state_dict()})
    mgr.close()
    rparams = jax.tree.map(jnp.asarray, tree)
    target = {"params": rparams, "opt": r_init_state(rparams)}
    got_step, got, extra = r_ckpt.CheckpointManager(
        str(tmp_path)).restore_latest(target)
    assert got_step == 1 and extra == {"data": {"step": 2}}
    assert int(got["opt"]["count"]) == 2
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(jnp.asarray, state))
    for a, b in zip(jax.tree.leaves(got), leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert float(np.abs(np.asarray(got["params"]["mtp"]["proj"])
                        - tree["mtp"]["proj"]).max()) > 0
    p, o, _ = train_state_from_checkpoint(str(tmp_path), 1, cfg)
    assert o["count"] == 2
    for a, b in zip(leaves((p, o["m"], o["v"])),
                    leaves((params, opt["m"], opt["v"]))):
        assert torch.equal(a, b)
