"""The port's encoder-decoder and cross-attention serving path (Whisper-
large-v3, Llama-3.2-Vision-11B) against the reference, on the CPU.

Parameters are the reference's `init_params` of each smoke config
(float32) converted by `params_from_jax`. The reference initialises some
leaves to zero: the cross-attention gate ``gate_attn`` (tanh(0) = 0, so a
gated block would add nothing), the attention biases and LayerNorm's
``b``. Every test here first sets each all-zero leaf from a seeded
normal draw (`seeded_zero_leaves`), so that a wrong gate, bias or norm
shows. Prompts and frontend embeddings are seeded numpy. The reference
runs jitted with ``use_pallas=False``, the port on CPU tensors (its
kernels' plain versions). Caches cross by `cache_to_numpy` /
`cache_from_jax`.

Bounds as in tests/test_torch_decode.py: float32 max |got - want| <=
5e-4 max |want| for logits and every cache tensor; the bfloat16 cell
2e-2; the loss 1e-6 relative and each gradient leaf 1e-5 relative in L2.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_decode import (F32_BOUND, assert_cache, assert_logits,
                               prompt, rel_err)
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

from repro.configs import registry as r_registry
from repro.models import layers as RL
from repro.models import model as R
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax, params_to_numpy)
from repro_torch.tree import leaves, tree_map, unflatten

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


def seeded_zero_leaves(tree, seed: int):
    """`tree` (numpy leaves) with every all-zero leaf (the gates, the
    attention biases, LayerNorm's b) replaced by a seeded N(0, 0.5^2)
    draw of its shape and dtype; the other leaves as they are."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(fill, tree)


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str):
    """The reference's smoke `init_params` (float32) at seed 0 with its
    zero leaves drawn (seed 5), as numpy; kept for the file's tests."""
    tree = R.init_params(r_registry.get_smoke_config(arch),
                         jax.random.PRNGKey(0))
    return seeded_zero_leaves(jax.tree.map(np.asarray, tree), 5)


def reference_model(arch: str, dtype: str = "float32"):
    """(reference config, port config, reference params, the port's
    converted copy), every zero-initialised leaf set from a seeded
    draw."""
    rcfg = dataclasses.replace(r_registry.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    tree = jax.tree.map(lambda a: a.astype(rcfg.jdtype), _reference_init(arch))
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree,
                                                                       cfg)


def frontend(cfg, b: int, seed: int) -> np.ndarray:
    """Seeded frontend-stub embeddings (b, n_frontend_tokens,
    frontend_dim), float32."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def reference_fns(rcfg, cache_len: int):
    prefill = jax.jit(lambda p, t, f: R.forward(
        p, rcfg, t, f, mode="prefill", cache_len=cache_len))
    decode = jax.jit(lambda p, t, c: R.decode_step(p, rcfg, t, c))
    return prefill, decode


def test_configs_are_the_reference_s():
    """Full and smoke configs field for field (the port's `use_kernels`
    for the reference's `use_pallas`), their decoder and encoder
    segments; the full configs' widths as published."""
    for arch in ARCHS:
        for get, rget in ((registry.get_config, r_registry.get_config),
                          (registry.get_smoke_config,
                           r_registry.get_smoke_config)):
            a, b = dataclasses.asdict(get(arch)), dataclasses.asdict(rget(arch))
            assert a.pop("use_kernels") and not b.pop("use_pallas")
            assert a == b
            segs = lambda layout: [([dataclasses.astuple(bd) for bd in pat], n)
                                   for pat, n in layout]
            assert segs(get(arch).segments()) == segs(rget(arch).segments())
            assert segs(get(arch).enc_segments()) == \
                segs(rget(arch).enc_segments())
    w, v = (registry.get_config(a) for a in ARCHS)
    assert (w.num_layers, w.enc_layers, w.d_model, w.num_heads, w.hd,
            w.n_frontend_tokens, w.rope_theta) == (32, 32, 1280, 20, 64,
                                                   1500, 0.0)
    assert (v.num_layers, v.d_model, v.num_heads, v.num_kv_heads, v.hd,
            v.n_frontend_tokens, v.tie_embeddings) == (40, 4096, 32, 8, 128,
                                                       4100, False)
    assert [bd.mixer for bd in v.pattern] == ["attn"] * 4 + ["xattn"]


# (s, mlen): the reference pads the keys to 128 and masks them with
# kv_len (s * mlen >= 128^2), or takes `mha_reference`
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("s,mlen", [(128, 200), (8, 24)])
def test_cross_attention_matches_reference(gated, s, mlen):
    """`cross_attention` alone, gate, q/k norms and projections drawn
    from a seed: over a sequence (the port's flash path), then one token
    against the returned cache (its `decode_attention` path); the cache
    is the memory's un-normed projections, as the reference's."""
    rcfg = r_registry.get_smoke_config("llama-3.2-vision-11b")
    cfg = registry.get_smoke_config("llama-3.2-vision-11b")
    tree = jax.tree.map(np.asarray,
                        RL.init_cross_attention(jax.random.PRNGKey(3), rcfg,
                                                jnp.float32))
    tree = seeded_zero_leaves(tree, 6)
    rng = np.random.default_rng(7)
    tree["qnorm"]["w"] = rng.uniform(0.5, 1.5, tree["qnorm"]["w"].shape
                                     ).astype(np.float32)
    tree["knorm"]["w"] = rng.uniform(0.5, 1.5, tree["knorm"]["w"].shape
                                     ).astype(np.float32)
    assert tree["gate_attn"].any()
    p = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, mlen, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    want, want_c = RL.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem),
                                      rcfg, gated=gated)
    got, cache = L.cross_attention(p, torch.from_numpy(x),
                                   torch.from_numpy(mem), cfg, gated)
    assert rel_err(got.numpy(), want) <= F32_BOUND
    for n in ("k", "v"):
        assert cache[n].shape == (2, cfg.num_kv_heads, mlen, cfg.hd)
        assert rel_err(cache[n].numpy(), want_c[n]) <= F32_BOUND
    want1, _ = RL.cross_attention(jp, jnp.asarray(x[:, :1]), None, rcfg,
                                  gated=gated, cache=want_c)
    got1, same = L.cross_attention(p, torch.from_numpy(x[:, :1]), None, cfg,
                                   gated, cache)
    assert same is cache
    assert rel_err(got1.numpy(), want1) <= F32_BOUND


def serve_against_reference(arch: str, dtype: str, bound: float, b: int,
                            s: int, cache_len: int, steps_: int):
    """Prefill over a prompt and frontend embeddings, then `steps_` greedy
    decode steps, logits and every cache tensor (k, v, xk, xv) held
    against the reference's after each; the reference's argmax feeds
    both, and the port's must equal it."""
    rcfg, cfg, jp, params = reference_model(arch, dtype)
    tok = prompt(cfg.vocab_size, b, s, 11)
    fe = frontend(cfg, b, 12)
    prefill, decode = reference_fns(rcfg, cache_len)
    want_lg, want_c = prefill(jp, jnp.asarray(tok), jnp.asarray(fe))
    got_lg, cache = M.forward(params, cfg, torch.from_numpy(tok),
                              torch.from_numpy(fe), mode="prefill",
                              cache_len=cache_len)
    assert_logits(got_lg, want_lg, bound, f"{arch} prefill")
    assert_cache(cache, cfg, want_c, bound, f"{arch} prefill")
    names = {n for seg in cache["segments"] for per in seg for c in per
             for n in c}
    assert {"xk", "xv"} <= names
    for step in range(steps_):
        nxt = np.argmax(np.asarray(want_lg[:, -1:]), axis=-1).astype(np.int32)
        if dtype == "float32":
            assert np.array_equal(nxt, got_lg[:, -1:].argmax(-1).numpy())
        want_lg, want_c = decode(jp, jnp.asarray(nxt), want_c)
        got_lg, cache = M.decode_step(params, cfg, torch.from_numpy(nxt),
                                      cache)
        assert got_lg.shape == (b, 1, cfg.vocab_size)
        assert_logits(got_lg, want_lg, bound, f"{arch} step {step}")
        assert_cache(cache, cfg, want_c, bound, f"{arch} step {step}")
    assert int(cache["pos"]) == s + steps_


@pytest.mark.parametrize("arch,dtype,bound,steps_", [
    ("whisper-large-v3", "float32", F32_BOUND, 3),
    ("llama-3.2-vision-11b", "float32", F32_BOUND, 3),
    ("whisper-large-v3", "bfloat16", 2e-2, 1)])
def test_prefill_and_decode_match_reference(arch, dtype, bound, steps_):
    serve_against_reference(arch, dtype, bound, 2, 12, 20, steps_)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_teacher_forced_forward(arch):
    """The port alone: 4 greedy decode steps after a prefill equal the
    train forward over the prompt and the tokens fed, at each position,
    with the same frontend embeddings."""
    cfg = registry.get_smoke_config(arch)
    params = M.init_params(cfg, 1, "cpu")
    for t in leaves(params):  # the zero leaves: gates, biases, norm b
        if not t.any():
            t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                .manual_seed(t.numel())) * 0.5)
    tok = torch.from_numpy(prompt(cfg.vocab_size, 2, 10, 8))
    fe = torch.from_numpy(frontend(cfg, 2, 9))
    logits, cache = M.forward(params, cfg, tok, fe, mode="prefill",
                              cache_len=16)
    fed, outs = [], []
    nxt = logits[:, -1:].argmax(-1)
    for _ in range(4):
        fed.append(nxt)
        lg, cache = M.decode_step(params, cfg, nxt, cache)
        outs.append(lg[:, 0])
        nxt = lg[:, -1:].argmax(-1)
    full = M.forward(params, cfg, torch.cat([tok] + fed, 1), fe)
    for i, o in enumerate(outs):
        want = full[:, 10 + i]
        assert (o - want).abs().max() <= F32_BOUND * want.abs().max(), i


@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_matches_reference(arch):
    rcfg = r_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    want = jax.eval_shape(lambda: R.make_cache(rcfg, 3, 40))
    got = M.make_cache(cfg, 3, 40, device="cpu")
    assert got["pos"].shape == () and got["pos"].dtype == torch.int32
    assert all(t.dtype == torch.float32 and not t.any()
               for t in leaves(got["segments"]))
    assert [x.shape for x in leaves(cache_to_numpy(got, cfg)["segments"])] \
        == [x.shape for x in jax.tree.leaves(want["segments"])]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_round_trip(arch):
    """`params_from_jax` / `params_to_numpy` carry `enc_segments`,
    `enc_final_norm`, `lm_head` and `frontend_proj` bit for bit, and
    `cache_from_jax` / `cache_to_numpy` a prefill cache with its xk / xv;
    `init_params` makes the same tree."""
    rcfg, cfg, jp, params = reference_model(arch)
    extra = {"whisper-large-v3": {"enc_segments", "enc_final_norm"},
             "llama-3.2-vision-11b": {"lm_head", "frontend_proj"}}[arch]
    assert extra <= set(params) and extra <= set(jp)
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(jp), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = M.init_params(cfg, 0, "cpu")
    assert [tuple(t.shape) for t in leaves(params)] == \
        [tuple(t.shape) for t in leaves(mine)]
    _, want = reference_fns(rcfg, 20)[0](
        jp, jnp.asarray(prompt(cfg.vocab_size, 2, 12, 6)),
        jnp.asarray(frontend(cfg, 2, 6)))
    cache = cache_from_jax(jax.tree.map(np.asarray, want), cfg)
    assert int(cache["pos"]) == 12
    for a, b in zip(jax.tree.leaves(want), leaves(cache_to_numpy(cache, cfg))):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_frontend_matches_reference(arch):
    """`lm_loss` with frontend embeddings and its gradients, every leaf
    (the encoder's, the gates', the untied head's, the projection's)."""
    rcfg, cfg, jp, params = reference_model(arch)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tgt = np.concatenate([tok[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    fe = frontend(cfg, 2, 2)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, x, y, f: R.lm_loss(p, rcfg, x, y, f)))(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jnp.asarray(fe))
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = M.lm_loss(live, cfg, torch.from_numpy(tok), torch.from_numpy(tgt),
                     torch.from_numpy(fe))
    # a 'dec' block's cross-attention is ungated: its gate_attn is unused
    # (None here, zeros in the reference's gradient)
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(live), grads)]
    got_g = leaves(params_to_numpy(unflatten(params, grads), cfg))
    want_g = [np.asarray(x, np.float32) for x in jax.tree.leaves(want_g)]
    assert len(got_g) == len(want_g)
    # the key bias's gradient is zero in exact arithmetic (a softmax row
    # does not change when one constant is added to all its scores): both
    # sides hold float32 rounding noise, held to 1e-6 of the largest leaf
    floor = 1e-6 * max(np.linalg.norm(w) for w in want_g)
    for g, w in zip(got_g, want_g):
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w) + floor
    # one stacked gate_attn leaf per 'dec' segment
    assert sum(not np.any(w) for w in want_g) == (
        len(cfg.segments()) if cfg.enc_layers else 0)


def test_step_builders_serve_both():
    """`make_prefill_step(cfg, L)(params, tokens, frontend_embeds)` with
    numpy inputs (moved to the params' device) and `make_decode_step`
    against the reference, for both architectures; the train step
    passes the embeddings to `lm_loss`."""
    for arch in ARCHS:
        rcfg, cfg, jp, params = reference_model(arch)
        tok = prompt(cfg.vocab_size, 2, 13, 4)
        fe = frontend(cfg, 2, 4)
        prefill, decode = reference_fns(rcfg, 20)
        want_lg, want_c = prefill(jp, jnp.asarray(tok[:, :12]),
                                  jnp.asarray(fe))
        got_lg, cache = steps.make_prefill_step(cfg, 20)(params, tok[:, :12],
                                                         fe)
        assert not got_lg.requires_grad
        assert_logits(got_lg, want_lg, F32_BOUND, f"{arch} prefill")
        assert_cache(cache, cfg, want_c, F32_BOUND, f"{arch} prefill")
        want_lg, want_c = decode(jp, jnp.asarray(tok[:, 12:]), want_c)
        got_lg, cache = steps.make_decode_step(cfg)(params, tok[:, 12:],
                                                    cache)
        assert_logits(got_lg, want_lg, F32_BOUND, f"{arch} decode")
        assert_cache(cache, cfg, want_c, F32_BOUND, f"{arch} decode")
    from repro_torch.optim.adamw import AdamWConfig, init_state

    tgt = np.concatenate([tok[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    opt = init_state(params)
    loss_want = M.lm_loss(params, cfg, torch.from_numpy(tok),
                          torch.from_numpy(tgt), torch.from_numpy(fe))
    _, _, metrics = steps.make_train_step(cfg, AdamWConfig())(
        tree_map(torch.clone, params), opt, torch.from_numpy(tok),
        torch.from_numpy(tgt), torch.from_numpy(fe))
    assert metrics["loss"].item() == loss_want.item()
