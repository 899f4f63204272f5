"""The port's serving path against the reference, on the CPU: prefill
into a decode cache, cached decode, `make_cache` and the step builders.

Parameters are the reference's `init_params` converted by
`params_from_jax`; prompts are seeded numpy. The reference runs jitted
with ``use_pallas=False`` (its attention and scan take their plain
references), the port on CPU tensors (its kernels' plain versions).
Caches cross by `cache_to_numpy` / `cache_from_jax`.

Bounds: float32 max |got - want| <= 5e-4 max |want| for logits and for
every cache tensor (the reference's own decode bound,
tests/test_models.py:69); the bfloat16 cell 2e-2 (activations round to
bf16 at other places in the two frameworks, ~2^-8 each, over 4 layers).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as r_smoke_config
from repro.models import model as R
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.rglru import ops as scan_ops
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.tree import leaves

F32_BOUND = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


def configs(arch: str, dtype: str = "float32"):
    """(the reference's smoke config, the port's) in `dtype`."""
    return (dataclasses.replace(r_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str):
    """The reference's `init_params` of the smoke config (float32) at
    seed 0, kept for the file's other tests (its first call per
    architecture compiles for seconds)."""
    return R.init_params(r_smoke_config(arch), jax.random.PRNGKey(0))


def reference_model(arch: str, dtype: str = "float32"):
    """(reference config, port config, reference params, the port's
    converted copy). bfloat16 rounds the float32 init (every leaf: the
    architectures used so have no float32-only leaf)."""
    rcfg, cfg = configs(arch, dtype)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(rcfg.jdtype),
                        _reference_init(arch))
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree,
                                                                       cfg)


def prompt(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / (
        float(np.max(np.abs(want))) + 1e-12)


def assert_logits(got: torch.Tensor, want, bound: float, what: str) -> None:
    err = rel_err(got.float().numpy(), want)
    assert err <= bound, f"{what}: logits relative error {err:.3g} > {bound}"


def assert_cache(cache, cfg, want, bound: float, what: str) -> None:
    """Every tensor of the port's cache against the reference's."""
    got = cache_to_numpy(cache, cfg)
    assert int(got["pos"]) == int(want["pos"]), what
    got_l, want_l = leaves(got["segments"]), jax.tree.leaves(want["segments"])
    assert len(got_l) == len(want_l) > 0
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        err = rel_err(g, w)
        assert err <= bound, f"{what}: cache leaf {i} error {err:.3g}"


@functools.lru_cache(maxsize=None)
def reference_fns(rcfg, cache_len: int):
    """The reference's prefill and decode step, jitted (kept: a repeated
    call at the same shapes reuses the compile)."""
    prefill = jax.jit(lambda p, t: R.forward(p, rcfg, t, mode="prefill",
                                             cache_len=cache_len))
    decode = jax.jit(lambda p, t, c: R.decode_step(p, rcfg, t, c))
    return prefill, decode


def check_prefill_and_decode(arch: str, dtype: str = "float32",
                             bound: float = F32_BOUND, b: int = 2,
                             s: int = 12, cache_len: int = 24) -> None:
    """Prefill logits and cache, then one decode step's logits and cache,
    against the reference's."""
    rcfg, cfg, jp, params = reference_model(arch, dtype)
    tok = prompt(cfg.vocab_size, b, s + 1, 1)
    prefill, decode = reference_fns(rcfg, cache_len)
    want_lg, want_c = prefill(jp, jnp.asarray(tok[:, :s]))
    got_lg, cache = M.forward(params, cfg, torch.from_numpy(tok[:, :s]),
                              mode="prefill", cache_len=cache_len)
    assert got_lg.dtype == torch.float32 and cache["pos"].dtype == torch.int32
    assert_logits(got_lg, want_lg, bound, f"{arch} prefill")
    assert_cache(cache, cfg, want_c, bound, f"{arch} prefill")
    want_lg, want_c = decode(jp, jnp.asarray(tok[:, s:]), want_c)
    got_lg, same = M.decode_step(params, cfg, torch.from_numpy(tok[:, s:]),
                                 cache)
    assert same is cache and got_lg.shape == (b, 1, cfg.vocab_size)
    assert_logits(got_lg, want_lg, bound, f"{arch} decode")
    assert_cache(cache, cfg, want_c, bound, f"{arch} decode")


@pytest.mark.parametrize("arch,dtype,bound,cache_len", [
    ("smollm-135m", "float32", F32_BOUND, 24),
    ("recurrentgemma-9b", "float32", F32_BOUND, 32),
    ("smollm-135m", "bfloat16", 2e-2, 24)])
def test_prefill_and_decode_step_match_reference(arch, dtype, bound,
                                                 cache_len):
    check_prefill_and_decode(arch, dtype, bound, cache_len=cache_len)


def greedy_against_reference(prompt_len: int, cache_len: int, steps_: int):
    """RecurrentGemma's smoke config (window 16), batch 2: prefill, then
    `steps_` greedy decode steps, logits and every cache tensor held
    against the reference's after each; the reference's argmax feeds
    both, and the port's must equal it."""
    rcfg, cfg, jp, params = reference_model("recurrentgemma-9b")
    tok = prompt(cfg.vocab_size, 2, prompt_len, 3)
    prefill, decode = reference_fns(rcfg, cache_len)
    want_lg, want_c = prefill(jp, jnp.asarray(tok))
    got_lg, cache = M.forward(params, cfg, torch.from_numpy(tok),
                              mode="prefill", cache_len=cache_len)
    assert_logits(got_lg, want_lg, F32_BOUND, "prefill")
    assert_cache(cache, cfg, want_c, F32_BOUND, "prefill")
    for step in range(steps_):
        nxt = np.argmax(np.asarray(want_lg[:, -1:]), axis=-1).astype(np.int32)
        assert np.array_equal(nxt, got_lg[:, -1:].argmax(-1).numpy()), step
        want_lg, want_c = decode(jp, jnp.asarray(nxt), want_c)
        got_lg, cache = M.decode_step(params, cfg, torch.from_numpy(nxt),
                                      cache)
        assert_logits(got_lg, want_lg, F32_BOUND, f"step {step}")
        assert_cache(cache, cfg, want_c, F32_BOUND, f"step {step}")
    return cfg, cache


def test_recurrentgemma_greedy_wraps_the_rolling_buffer():
    """12 prompt tokens and 5 greedy steps at cache_len 32: the swa cache
    is the window's rolling buffer (16 slots), which positions 16 and
    after wrap."""
    cfg, cache = greedy_against_reference(12, 32, 5)
    assert int(cache["pos"]) == 17 > cfg.window
    assert cache["segments"][0][0][2]["k"].shape[2] == cfg.window


def test_recurrentgemma_cache_shorter_than_window():
    """cache_len 12 < window 16: the swa cache holds 12 slots, and decode
    goes through `decode_attention` with its length and window masks."""
    cfg, cache = greedy_against_reference(8, 12, 4)
    assert cache["segments"][0][0][2]["k"].shape[2] == 12 < cfg.window


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b"])
def test_make_cache_matches_reference(arch):
    rcfg, cfg = configs(arch)
    want = jax.eval_shape(lambda: R.make_cache(rcfg, 3, 40))
    got = M.make_cache(cfg, 3, 40, device="cpu")
    assert got["pos"].shape == () and got["pos"].dtype == torch.int32
    assert all(t.dtype == torch.float32 and not t.any()
               for t in leaves(got["segments"]))
    assert [len(seg) for seg in got["segments"]] == \
        [n for _, n in cfg.segments()]
    assert [x.shape for x in leaves(cache_to_numpy(got, cfg)["segments"])] \
        == [x.shape for x in jax.tree.leaves(want["segments"])]


def test_step_builders_match_reference():
    """`make_prefill_step` with and without cache_len and
    `make_decode_step` (SmolLM smoke; int arrays in, moved to the params'
    device) against the reference's prefill and decode step at the
    shapes of the float32 cell above."""
    rcfg, cfg, jp, params = reference_model("smollm-135m")
    tok = prompt(cfg.vocab_size, 2, 13, 1)
    prefill, decode = reference_fns(rcfg, 24)
    want_lg, want_c = prefill(jp, jnp.asarray(tok[:, :12]))
    assert_logits(steps.make_prefill_step(cfg)(params, tok[:, :12]),
                  want_lg, F32_BOUND, "train-form prefill")
    got_lg, cache = steps.make_prefill_step(cfg, 24)(params, tok[:, :12])
    assert not got_lg.requires_grad
    assert_logits(got_lg, want_lg, F32_BOUND, "prefill")
    assert_cache(cache, cfg, want_c, F32_BOUND, "prefill")
    want_lg, want_c = decode(jp, jnp.asarray(tok[:, 12:]), want_c)
    got_lg, cache = steps.make_decode_step(cfg)(params, tok[:, 12:], cache)
    assert_logits(got_lg, want_lg, F32_BOUND, "decode")
    assert_cache(cache, cfg, want_c, F32_BOUND, "decode")


def test_cache_from_jax_round_trip():
    rcfg, cfg, jp, _ = reference_model("recurrentgemma-9b")
    _, want = reference_fns(rcfg, 32)[0](
        jp, jnp.asarray(prompt(cfg.vocab_size, 2, 12, 6)))
    cache = cache_from_jax(jax.tree.map(np.asarray, want), cfg)
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 12
    back = cache_to_numpy(cache, cfg)
    for a, b in zip(jax.tree.leaves(want), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_decode_steps_never_reach_the_scan_kernel(monkeypatch):
    """With use_kernels on, the prefill's T >= 8 scans take `rglru_scan`
    (its plain version on CPU tensors) and a decode step's T = 1 scans
    the plain version, as the reference dispatches."""
    cfg = get_smoke_config("recurrentgemma-9b")
    assert cfg.use_kernels
    calls = []
    real = scan_ops.rglru_scan

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(scan_ops, "rglru_scan", counting)
    params = M.init_params(cfg, 0, "cpu")
    tok = torch.from_numpy(prompt(cfg.vocab_size, 2, 9, 7))
    _, cache = M.forward(params, cfg, tok[:, :8], mode="prefill",
                         cache_len=16)
    n_rg = sum(bd.mixer == "rglru" for pat, n in cfg.segments()
               for bd in pat for _ in range(n))
    assert len(calls) == n_rg and all(s[1] == 8 for s in calls)
    M.decode_step(params, cfg, tok[:, 8:], cache)
    assert len(calls) == n_rg


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b",
                                  "gemma-7b", "minicpm-2b", "command-r-35b"])
def test_decode_matches_teacher_forced_forward(arch):
    """The port alone: 4 decode steps after a prefill equal the train
    forward over the whole sequence at each position (the reference's
    tests/test_models.py check)."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 1, "cpu")
    tok = torch.from_numpy(prompt(cfg.vocab_size, 2, 14, 8))
    _, cache = M.forward(params, cfg, tok[:, :10], mode="prefill",
                         cache_len=20)
    outs = [M.decode_step(params, cfg, tok[:, t:t + 1], cache)[0][:, 0]
            for t in range(10, 14)]
    full = M.forward(params, cfg, tok)
    for i, o in enumerate(outs):
        want = full[:, 10 + i]
        assert (o - want).abs().max() <= F32_BOUND * want.abs().max(), i


def test_prefill_refuses_a_short_cache_and_frontends():
    """A prefill refuses a cache shorter than the prompt and a missing
    cache_len. Frontend embeddings given to a model without a frontend
    are accepted and unused, as the reference's are: the logits equal
    those of the call without them."""
    cfg = get_smoke_config("smollm-135m")
    params = M.init_params(cfg, 0, "cpu")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="cache of 4"):
        M.forward(params, cfg, tok, mode="prefill", cache_len=4)
    with pytest.raises(ValueError, match="cache_len"):
        M.forward(params, cfg, tok, mode="prefill")
    assert torch.equal(M.forward(params, cfg, tok, torch.zeros((1, 2, 4))),
                       M.forward(params, cfg, tok))
