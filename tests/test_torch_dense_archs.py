"""The three dense decoders the port serves beside SmolLM-135M and
RecurrentGemma-9B (Gemma-7B, MiniCPM-2B, Command-R-35B), against the
reference on the CPU: their configs, prefill and a decode step, and
Command-R's LayerNorm through `lm_loss` and its gradients.

Parameters are the reference's `init_params` of each smoke config
(float32) converted by `params_from_jax`; prompts are seeded numpy. The
reference runs jitted with ``use_pallas=False``, the port on CPU
tensors. Bounds as in tests/test_torch_decode.py: prefill and decode
logits and every cache tensor within 5e-4 of the reference's largest
magnitude; the loss 1e-6 relative and each gradient leaf 1e-5 relative
in L2 (float32 sums in another order), as
tests/test_torch_model.py holds SmolLM's and RecurrentGemma's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_decode import check_prefill_and_decode, reference_model
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

from repro.configs import registry as r_registry
from repro.models.layers import layer_norm as r_layer_norm
from repro.models.model import lm_loss as r_lm_loss
from repro_torch.configs import minicpm_2b, registry
from repro_torch.models import layers as L
from repro_torch.models.convert import params_to_numpy
from repro_torch.models.model import init_params, lm_loss
from repro_torch.tree import leaves, tree_map, unflatten

DENSE = ("gemma-7b", "minicpm-2b", "command-r-35b")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


def test_configs_are_the_reference_s():
    """Full and smoke configs field for field (the port's `use_kernels`
    for the reference's `use_pallas`), MiniCPM's WSD extras too; the
    full configs' widths as published."""
    for arch in DENSE:
        for get, rget in ((registry.get_config, r_registry.get_config),
                          (registry.get_smoke_config,
                           r_registry.get_smoke_config)):
            a, b = dataclasses.asdict(get(arch)), dataclasses.asdict(rget(arch))
            assert a.pop("use_kernels") and not b.pop("use_pallas")
            assert a == b
    from repro.configs import minicpm_2b as r_minicpm

    assert minicpm_2b.SCHEDULE == r_minicpm.SCHEDULE
    g, m, c = (registry.get_config(a) for a in DENSE)
    assert (g.num_layers, g.d_model, g.num_heads, g.hd, g.d_ff) == \
        (28, 3072, 16, 256, 24576)
    assert (m.num_layers, m.d_model, m.num_heads, m.hd, m.d_ff) == \
        (40, 2304, 36, 64, 5760)
    assert (c.num_layers, c.d_model, c.num_kv_heads, c.hd, c.norm) == \
        (40, 8192, 8, 128, "layernorm")


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(r_layer_norm(*map(jnp.asarray, (x, w, b))))
    got = L.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    p = L.init_norm(64, "layernorm", torch.float32, "cpu")
    assert torch.equal(p["w"], torch.ones(64)) and not p["b"].any()


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_step_match_reference(arch):
    check_prefill_and_decode(arch)


def test_command_r_lm_loss_and_grads_match_reference():
    """LayerNorm's w and b get their gradients, as every other leaf."""
    rcfg, cfg, jp, params = reference_model("command-r-35b")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tgt = np.concatenate([tok[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, x, y: r_lm_loss(p, rcfg, x, y)))(
        jp, jnp.asarray(tok), jnp.asarray(tgt))
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm_loss(live, cfg, torch.from_numpy(tok), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, leaves(live))
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    assert "b" in params["final_norm"] and "b" in \
        params["segments"][0][0][0]["norm1"]
    got_g = leaves(params_to_numpy(unflatten(params, grads), cfg))
    want_g = [np.asarray(x, np.float32) for x in jax.tree.leaves(want_g)]
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w) + 1e-12


def test_command_r_params_round_trip_with_layer_norm_bias():
    rcfg, cfg, jp, params = reference_model("command-r-35b")
    back = params_to_numpy(params, cfg)
    assert back["final_norm"].keys() == {"w", "b"}
    for a, b in zip(jax.tree.leaves(jp), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = init_params(cfg, 0, "cpu")
    assert [tuple(t.shape) for t in leaves(params)] == \
        [tuple(t.shape) for t in leaves(mine)]
