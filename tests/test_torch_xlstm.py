"""The port's xLSTM against the reference, on the CPU: the mLSTM in its
three forms (quadratic for S <= 256, chunkwise beyond it, recurrent for
a decode step), the sLSTM scan with and without a cache, their
gradients, xLSTM-350M's smoke config (FFN-less blocks) through
`lm_loss`, prefill and decode, the conversions and `run_plain`; and
block rematerialisation (``cfg.remat``) on the xLSTM and SmolLM smoke
configs.

Parameters are the port's `init_params` in the reference's layout
(`params_to_numpy`; the same tree as the reference's, asserted by
tests/test_torch_model.py) with every constant leaf drawn (seed 5): an
all-zero leaf (the sLSTM's ``b_gates``) from N(0, 0.5^2), an all-one
leaf (the norms) from U[0.5, 1.5], and the mLSTM's gate bias ``b_if``
(0 for i, 3 for f) moved by N(0, 1), so that a port that ignored a bias
or a norm would fail. A bfloat16 tree rounds every leaf but ``b_if`` and
``b_gates``, which are float32 in any model dtype, as the reference's.
Inputs are seeded numpy. The reference runs with ``use_pallas=False``,
the port on CPU tensors.

The reference's jitted programs are compiled with XLA's
``xla_allow_excess_precision`` off (`precise_jit`): by default XLA drops
the round trips to bfloat16 that the reference's source writes (the
sLSTM's recurrent product, the matmuls' outputs), which the port keeps,
as the reference does op by op. So compiled, the reference's bfloat16
loss equals the port's to ~1e-7.

Tolerances (max |got - want| <= bound x max |want|, per tensor):
float32 1e-4 on outputs, states and logits (float32 sums in another
order), 1e-3 on gradients (through exponentials of the gate sums);
bfloat16 2e-2 on the loss, logits and caches. bfloat16 gradients are
held as one vector, ||got - want|| <= 5e-2 ||want||: in this model a
one-ulp difference in a bf16 cotangent (float32 sums in another order
before the rounding) grows to 1-6 % of a leaf's gradient (0.9-2.8 % of
the whole over 5 seeded batches), and the reference's own default
compile moves its bf16 gradients by 50-200 % against its precise
compile. Rematerialisation changes no number: its gradients equal the
plain backward's exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

import repro.launch.train as r_train
from repro.configs import registry as r_registry
from repro.models import layers as RL
from repro.models import model as R
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps, train
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax, params_to_numpy)
from repro_torch.tree import leaves, tree_map, unflatten

ARCH = "xlstm-350m"
F32_BOUND = 1e-4
GRAD_BOUND = 1e-3
BF16_BOUND = 2e-2
BF16_GRAD_BOUND = 5e-2
# the leaves that stay float32 in a bfloat16 model
F32_LEAVES = ("b_if", "b_gates")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / (
        float(np.max(np.abs(want))) + 1e-12)


def assert_close(got, want, bound: float, what: str) -> None:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    err = rel_err(got, want)
    assert err <= bound, f"{what}: relative error {err:.3g} > {bound}"


# XLA's excess precision off (module docstring)
PRECISE = {"xla_allow_excess_precision": False}


def precise_jit(fn, *args):
    """`fn` jitted and compiled for `args` with `PRECISE`."""
    return jax.jit(fn).lower(*args).compile(PRECISE)


def drawn(tree, rng, name: str = ""):
    """`tree` (numpy leaves, nested dicts / lists / tuples) with its
    constant leaves drawn (module docstring)."""
    if isinstance(tree, dict):
        return {k: drawn(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(drawn(v, rng, name) for v in tree)
    a = np.asarray(tree)
    if name == "b_if":
        return (a + rng.standard_normal(a.shape)).astype(a.dtype)
    if a.size and not a.any():
        return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    if a.size and (a == 1).all():
        return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
    return a


def rounded(tree, dtype: str, name: str = ""):
    """`tree` in `dtype`, but for the float32-only leaves."""
    if dtype == "float32":
        return tree
    if isinstance(tree, dict):
        return {k: rounded(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rounded(v, dtype, name) for v in tree)
    return tree if name in F32_LEAVES else tree.astype(jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _tree(arch: str):
    """The smoke config's parameters (float32) in the reference's layout
    as numpy, constants drawn; kept for the file."""
    cfg = registry.get_smoke_config(arch)
    tree = params_to_numpy(M.init_params(cfg, 0, "cpu"), cfg)
    return drawn(tree, np.random.default_rng(5))


def model(arch: str = ARCH, dtype: str = "float32"):
    """(reference config, port config, reference params, the port's
    converted copy) in `dtype`."""
    rcfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                               dtype=dtype)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    tree = rounded(_tree(arch), dtype)
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree,
                                                                       cfg)


def block(mixer: str):
    """(reference config, port config, reference block params, the
    port's) of the smoke model's first `mixer` block, float32."""
    rcfg, cfg, jp, params = model()
    j = [bd.mixer for bd in cfg.pattern].index(mixer)
    rblk = jax.tree.map(lambda a: a[0], jp["segments"][0][j])["mixer"]
    return rcfg, cfg, rblk, params["segments"][0][0][j]["mixer"]


def inputs(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_state(got, want, bound: float, what: str) -> None:
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k].dtype == torch.float32, (what, k, got[k].dtype)
        assert_close(got[k], want[k], bound, f"{what} state {k}")


# -- the mixers --------------------------------------------------------------

def port_vjp(fn, p, x, cots):
    """(outputs, (parameter gradients, input gradient)) of the port's
    `fn(p, x)` -> (y, state) under the cotangents (gy, {name: g})."""
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    xt = x.clone().requires_grad_()
    y, st = fn(live, xt)
    gy, gst = cots
    grads = torch.autograd.grad([y] + [st[k] for k in gst],
                                leaves(live) + [xt],
                                [gy] + [gst[k] for k in gst])
    return (y, st), (unflatten(live, grads[:-1]), grads[-1])


def assert_grads(got, want, what: str) -> None:
    (gp, gx), (wp, wx) = got, want
    assert_close(gx, wx, GRAD_BOUND, f"{what} d/dx")
    got_l, want_l = leaves(gp), jax.tree.leaves(wp)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert_close(g, w, GRAD_BOUND, f"{what} parameter gradient {i}")


def cotangents(shapes, seed: int):
    rng = np.random.default_rng(seed)
    draw = lambda shape: rng.standard_normal(shape).astype(np.float32)
    y_shape, st_shapes = shapes
    return draw(y_shape), {k: draw(v) for k, v in st_shapes.items()}


@pytest.mark.parametrize("s", [1, 40, 256, 320, 321, 512])
def test_mlstm_block_matches_reference(s):
    """Output and the prefill's final (C, n, m) at S = 1, 40, 256 (the
    quadratic form), 320 (the chunkwise form, chunk 64: 256 halved until
    it divides S), 321 (the reference's chunk falls to 1; the port's
    stops at `MIN_CHUNK`, 64, with a last chunk of 1) and 512 (chunk
    256), then one recurrent step from that state; at S = 40 and 320 the
    gradients of the parameters and the
    input under seeded cotangents of the output and the state, against
    `jax.vjp`."""
    rcfg, cfg, rp, p = block("mlstm")
    x = inputs(cfg, 2, s + 1, s)
    b, dh, h = 2, 2 * cfg.d_model // cfg.num_heads, cfg.num_heads
    gy, gst = cotangents(((b, s, cfg.d_model), {
        "C": (b, h, dh, dh), "n": (b, h, dh), "m": (b, h)}), s + 100)
    grads = s in (40, 320)

    def ref(pp, xx, x1, gy, gst):
        fn = lambda q, z: RL.mlstm_block(q, z, rcfg, return_state=True)
        (y, st), vjp = jax.vjp(fn, pp, xx)
        y1, st1 = RL.mlstm_block(pp, x1, rcfg, cache=st)
        return y, st, y1, st1, (vjp((gy, gst)) if grads else None)

    args = (rp, jnp.asarray(x[:, :s]), jnp.asarray(x[:, s:]),
            jnp.asarray(gy), jax.tree.map(jnp.asarray, gst))
    want_y, want_st, want_y1, want_st1, want_g = precise_jit(ref, *args)(
        *args)
    fn = lambda q, z: L.mlstm_block(q, z, cfg, return_state=True)
    (got_y, got_st), got_g = port_vjp(fn, p, torch.from_numpy(x[:, :s]),
                                      (torch.from_numpy(gy), as_torch(gst)))
    assert_close(got_y, want_y, F32_BOUND, f"mlstm S={s}")
    assert_state(got_st, want_st, F32_BOUND, f"mlstm S={s}")
    if grads:
        assert_grads(got_g, want_g, f"mlstm S={s}")
    with torch.no_grad():
        got_y1, got_st1 = L.mlstm_block(p, torch.from_numpy(x[:, s:]), cfg,
                                        cache=got_st)
        _, none = L.mlstm_block(p, torch.from_numpy(x[:, :s]), cfg)
    assert_close(got_y1, want_y1, F32_BOUND, f"mlstm step after S={s}")
    assert_state(got_st1, want_st1, F32_BOUND, f"mlstm step after S={s}")
    assert none is None


@pytest.mark.parametrize("s", [40, 320])
def test_mlstm_forms_agree(s):
    """The port's three forms on one input: the chunkwise form (chunk 16)
    and the quadratic one, and the recurrent form stepped token by token
    from the zero state, outputs and final state."""
    _, cfg, _, p = block("mlstm")
    x = torch.from_numpy(inputs(cfg, 2, s, 7))
    _, q, k, v, li, lf = L.mlstm_inputs(p, x, cfg)
    par, par_st = L.mlstm_parallel(q, k, v, li, lf, return_state=True)
    chk, chk_st = L.mlstm_chunked(q, k, v, li, lf, 16)
    assert_close(chk, par.numpy(), F32_BOUND, "chunked vs quadratic")
    assert_state(chk_st, {n: t.numpy() for n, t in par_st.items()},
                 F32_BOUND, "chunked vs quadratic")
    st = M._block_cache(cfg.pattern[0], cfg, 2, 1, torch.float32, "cpu")
    outs = []
    for t in range(s):
        o, st = L.mlstm_step(st, q[:, :, t:t + 1], k[:, :, t:t + 1],
                             v[:, :, t:t + 1], li[..., t:t + 1],
                             lf[..., t:t + 1])
        outs.append(o)
    assert_close(torch.cat(outs, 2), chk.numpy(), F32_BOUND,
                 "recurrent vs chunked")
    assert_state(st, {n: t.numpy() for n, t in chk_st.items()}, F32_BOUND,
                 "recurrent vs chunked")


def _slstm_cache(cfg, b: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.d_model)
    return {"c": rng.standard_normal(shape).astype(np.float32),
            "n": rng.uniform(0.5, 3.0, shape).astype(np.float32),
            "h": rng.standard_normal(shape).astype(np.float32),
            "m": rng.standard_normal(shape).astype(np.float32)}


@pytest.mark.parametrize("cached", [False, True])
def test_slstm_block_matches_reference(cached):
    """The scan over 24 tokens from zeros (no state back) or from a drawn
    cache (the final state back, then one step from it, and the
    gradients of the parameters and the input under seeded cotangents of
    the output and the state, against `jax.vjp`)."""
    rcfg, cfg, rp, p = block("slstm")
    x = inputs(cfg, 2, 25, 11)
    if not cached:
        args = (rp, jnp.asarray(x[:, :24]))
        want_y, want_st = precise_jit(
            lambda pp, xx: RL.slstm_block(pp, xx, rcfg), *args)(*args)
        with torch.no_grad():
            got_y, got_st = L.slstm_block(p, torch.from_numpy(x[:, :24]), cfg)
        assert_close(got_y, want_y, F32_BOUND, "slstm")
        assert got_st is None and want_st is None
        return
    c0 = _slstm_cache(cfg, 2, 12)
    gy, gst = cotangents(((2, 24, cfg.d_model),
                          {k: v.shape for k, v in c0.items()}), 13)

    def ref(pp, xx, x1, c0, gy, gst):
        (y, st), vjp = jax.vjp(lambda q, z: RL.slstm_block(q, z, rcfg, c0),
                               pp, xx)
        y1, st1 = RL.slstm_block(pp, x1, rcfg, st)
        return y, st, y1, st1, vjp((gy, gst))

    args = (rp, jnp.asarray(x[:, :24]), jnp.asarray(x[:, 24:]),
            jax.tree.map(jnp.asarray, c0), jnp.asarray(gy),
            jax.tree.map(jnp.asarray, gst))
    want_y, want_st, want_y1, want_st1, want_g = precise_jit(ref, *args)(
        *args)
    fn = lambda q, z: L.slstm_block(q, z, cfg, as_torch(c0))
    (got_y, got_st), got_g = port_vjp(fn, p, torch.from_numpy(x[:, :24]),
                                      (torch.from_numpy(gy), as_torch(gst)))
    assert_close(got_y, want_y, F32_BOUND, "slstm")
    assert_state(got_st, want_st, F32_BOUND, "slstm")
    assert_grads(got_g, want_g, "slstm")
    with torch.no_grad():
        got_y1, got_st1 = L.slstm_block(p, torch.from_numpy(x[:, 24:]), cfg,
                                        got_st)
    assert_close(got_y1, want_y1, F32_BOUND, "slstm step")
    assert_state(got_st1, want_st1, F32_BOUND, "slstm step")


# -- the model ---------------------------------------------------------------

def batch(vocab: int, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tgt = np.concatenate([tok[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    tgt[0, :3] = -1
    return tok, tgt


def test_bf16_lm_loss_and_grads_match_reference():
    """xLSTM's smoke model in bfloat16 (7 FFN-less mLSTM blocks and an
    sLSTM block with its FFN) over 2 x 40 tokens: the loss, and the
    gradient as one vector (module docstring). The reference compiles
    with LLVM's optimisation off as well, which halves the compile on one
    core. (float32: `test_run_plain_matches_reference`'s first step.)"""
    rcfg, cfg, jp, params = model(dtype="bfloat16")
    tok, tgt = batch(cfg.vocab_size, 2, 40, 1)
    args = (jp, jnp.asarray(tok), jnp.asarray(tgt))
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, x, y: R.lm_loss(p, rcfg, x, y))).lower(*args).compile(
        dict(PRECISE, xla_backend_optimization_level=0))(*args)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = M.lm_loss(live, cfg, torch.from_numpy(tok), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, leaves(live))
    assert abs(loss.item() - float(want_loss)) <= BF16_BOUND * abs(
        float(want_loss))
    flat = lambda ts: np.concatenate([np.asarray(t, np.float32).ravel()
                                      for t in ts])
    got = flat(leaves(params_to_numpy(unflatten(params, grads), cfg)))
    want = flat(jax.tree.leaves(want_g))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= BF16_GRAD_BOUND, err


def assert_cache(cache, cfg, want, bound: float, what: str) -> None:
    got = cache_to_numpy(cache, cfg)
    assert int(got["pos"]) == int(want["pos"]), what
    got_l, want_l = leaves(got["segments"]), jax.tree.leaves(want["segments"])
    assert len(got_l) == len(want_l) == 25  # 7 x (C, n, m) + (c, n, h, m)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.dtype == np.float32 and np.asarray(w).dtype == np.float32
        assert_close(g, w, bound, f"{what}: cache leaf {i}")


def test_prefill_and_decode_match_reference():
    """A prefill of 320 tokens (the chunkwise form hands its state to the
    cache) and 4 decode steps through the step builders, float32: logits
    and every cache tensor against the reference's
    `forward(mode="prefill")` / `decode_step`. (In bfloat16 the two
    frameworks' float32 sums, in another order, now and then round a
    block's output to another bf16, ~7e-4 of it, and 8 layers of this
    random-weight model grow that to ~3e-2 of the logits: bfloat16 is
    held by `test_lm_loss_and_grads_match_reference`, and its cache's
    dtypes by `test_conversions_and_make_cache`.)"""
    dtype, s, n, bound = "float32", 320, 4, F32_BOUND
    rcfg, cfg, jp, params = model(dtype=dtype)
    tok = batch(cfg.vocab_size, 2, s + n, 3)[0]
    first = jnp.asarray(tok[:, :s])
    want_lg, want_c = precise_jit(lambda p, t: R.forward(
        p, rcfg, t, mode="prefill", cache_len=s + n), jp, first)(jp, first)
    decode = precise_jit(lambda p, t, c: R.decode_step(p, rcfg, t, c), jp,
                         jnp.asarray(tok[:, s:s + 1]), want_c)
    got_lg, cache = steps.make_prefill_step(cfg, s + n)(params, tok[:, :s])
    assert_close(got_lg, want_lg, bound, f"{dtype} prefill logits")
    assert_cache(cache, cfg, want_c, bound, f"{dtype} prefill")
    step = steps.make_decode_step(cfg)
    for i in range(s, s + n):
        want_lg, want_c = decode(jp, jnp.asarray(tok[:, i:i + 1]), want_c)
        got_lg, cache = step(params, torch.from_numpy(tok[:, i:i + 1]), cache)
        assert_close(got_lg, want_lg, bound, f"{dtype} decode {i} logits")
        assert_cache(cache, cfg, want_c, bound, f"{dtype} decode {i}")


def test_conversions_and_make_cache():
    """bfloat16 parameters and a decode cache through the conversions and
    back, bit for bit; ``b_if`` / ``b_gates`` and every state leaf stay
    float32 (after a bfloat16 prefill and decode step too); `make_cache`
    has the reference's layout, dtypes and values (m at -1e30); an
    FFN-less block has no ``norm2`` / ``ffn``."""
    rcfg, cfg, jp, params = model(dtype="bfloat16")
    tree = rounded(_tree(ARCH), "bfloat16")
    blk = params["segments"][0][0]
    assert "norm2" not in blk[0] and "ffn" not in blk[0]
    assert "norm2" in blk[7] and "ffn" in blk[7]
    assert blk[0]["mixer"]["b_if"].dtype == torch.float32
    assert blk[7]["mixer"]["b_gates"].dtype == torch.float32
    assert blk[0]["mixer"]["w_up"].dtype == torch.bfloat16
    back = params_to_numpy(params, cfg)
    for a, b in zip(jax.tree.leaves(tree), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    want = jax.tree.map(np.asarray, R.make_cache(rcfg, 2, 8))
    got = cache_to_numpy(M.make_cache(cfg, 2, 8, device="cpu"), cfg)
    for a, b in zip(jax.tree.leaves(want), leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    tok = batch(cfg.vocab_size, 2, 9, 4)[0]
    _, cache = steps.make_prefill_step(cfg, 12)(params, tok[:, :8])
    steps.make_decode_step(cfg)(params, torch.from_numpy(tok[:, 8:]), cache)
    assert all(t.dtype == torch.float32 for t in leaves(cache["segments"]))
    rng = np.random.default_rng(9)
    drawn_c = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), want)
    conv = cache_from_jax(drawn_c, cfg)
    assert all(t.dtype == torch.float32 for t in leaves(conv["segments"]))
    for a, b in zip(jax.tree.leaves(drawn_c),
                    leaves(cache_to_numpy(conv, cfg))):
        np.testing.assert_array_equal(a, b)


def test_first_loss_sits_at_log_vocab_plus_half():
    """At init the tied head's logits have variance 1 (RMS-normed states
    against an N(0, 1/d) embedding), so the first loss lies near
    ln V + 1/2, not ln V: what the card's full-width check expects."""
    cfg = registry.get_smoke_config(ARCH)
    params = M.init_params(cfg, 0, "cpu")
    tok, tgt = batch(cfg.vocab_size, 4, 64, 2)
    loss = float(M.lm_loss(params, cfg, torch.from_numpy(tok),
                           torch.from_numpy(tgt)))
    assert abs(loss - (math.log(cfg.vocab_size) + 0.5)) < 0.1, loss


# -- the trainer and rematerialisation ------------------------------------

class _RecordingJax:
    """Stands in for `jax` inside `repro.launch.train`: every `jit` it
    hands out compiles with `PRECISE` at its first call and records each
    call's outputs."""

    def __init__(self):
        self.programs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        compiled, calls = [], []
        self.programs.append(calls)

        def run(*args):
            if not compiled:
                compiled.append(jax.jit(fn, **kw).lower(*args).compile(
                    PRECISE))
            out = compiled[0](*args)
            calls.append(out)
            return out

        return run


def test_run_plain_matches_reference(monkeypatch):
    """3 smoke steps of `run_plain` against the reference's, both from
    this file's parameters (the reference's `init_params` replaced), and
    the port's `lm_loss` gradient on the first batch against the
    reference's first step's: losses 1e-5 relative, the gradient leaf by
    leaf at this file's float32 bound, and final parameters 1e-4 absolute
    (tests/test_torch_train.py's bounds); the first step's grad norm
    1e-3 relative (this file's gradient bound), the later ones' 1e-2
    (after clipped AdamW steps the two runs' weights differ by ~1e-5,
    which moves this model's gradient norms by up to 1.4e-3)."""
    args = train.parser().parse_args(
        ["--smoke", "--device", "cpu", "--log-every", "1", "--arch", ARCH,
         "--steps", "3", "--batch", "2", "--seq-len", "32"])
    tree = _tree(ARCH)
    rec = _RecordingJax()
    monkeypatch.setattr(r_train, "jax", rec)
    monkeypatch.setattr(r_train, "init_params", lambda cfg, key: jax.tree.map(
        jnp.asarray, tree))
    want_loss = r_train.run_plain(args)
    monkeypatch.setattr(r_train, "jax", jax)
    (calls,) = rec.programs
    cfg = registry.get_smoke_config(ARCH)
    res = train.run_plain(args, params=params_from_jax(tree, cfg))
    np.testing.assert_allclose(res.losses, [float(o[2]["loss"])
                                            for o in calls], rtol=1e-5)
    np.testing.assert_allclose(res.loss, want_loss, rtol=1e-5)
    # the first step's gradient, leaf by leaf, float32: the reference's
    # first AdamW moment is (1 - b1) x the clipped gradient
    tok, tgt = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len,
                                      args.batch, seed=args.seed)).next_batch()
    live = tree_map(lambda t: t.detach().requires_grad_(),
                    params_from_jax(tree, cfg))
    grads = torch.autograd.grad(M.lm_loss(live, cfg, torch.from_numpy(tok),
                                          torch.from_numpy(tgt)), leaves(live))
    clip = min(1.0, 1.0 / float(calls[0][2]["grad_norm"]))
    got_g = leaves(params_to_numpy(unflatten(live, grads), cfg))
    want_m = jax.tree.leaves(calls[0][1]["m"])
    assert len(got_g) == len(want_m)
    for i, (g, m) in enumerate(zip(got_g, want_m)):
        assert_close(g, np.asarray(m) / (0.1 * clip), GRAD_BOUND,
                     f"first step's gradient {i}")
    want_norms = [float(o[2]["grad_norm"]) for o in calls]
    np.testing.assert_allclose(res.grad_norms[0], want_norms[0],
                               rtol=GRAD_BOUND)
    np.testing.assert_allclose(res.grad_norms, want_norms, rtol=1e-2)
    got = leaves(params_to_numpy(res.params, cfg))
    want = jax.tree.leaves(calls[-1][0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["smollm-135m", ARCH])
def test_remat_changes_no_gradient(monkeypatch, arch):
    """`lm_loss`'s gradients under ``remat`` "block" and
    "block_save_flash" equal the plain backward's exactly; the flash
    forward runs once a layer without remat, twice under "block" (the
    recompute) and once under "block_save_flash" (its outputs kept); a
    model without attention runs it never."""
    calls = []
    plain_fwd = flash_ops.pair_fwd

    def counted(*a):
        calls.append(1)
        return plain_fwd(*a)

    monkeypatch.setattr(flash_ops, "pair_fwd", counted)
    _, cfg, _, params = model(arch)
    tok, tgt = batch(cfg.vocab_size, 2, 40, 4)
    got = {}
    for remat in M.REMATS:
        c = dataclasses.replace(cfg, remat=remat)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        del calls[:]
        loss = M.lm_loss(live, c, torch.from_numpy(tok),
                         torch.from_numpy(tgt))
        got[remat] = (loss.detach(),
                      torch.autograd.grad(loss, leaves(live)), len(calls))
    attn = sum(bd.mixer == "attn" for bd in cfg.pattern) * (
        cfg.num_layers // len(cfg.pattern))
    assert [got[r][2] for r in M.REMATS] == [attn, 2 * attn, attn]
    loss0, grads0, _ = got["none"]
    for remat in M.REMATS[1:]:
        loss, grads, _ = got[remat]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), remat
    # no checkpoint without autograd or with a cache asked for
    c = dataclasses.replace(cfg, remat="block")
    with torch.no_grad():
        lg = M.forward(params, c, torch.from_numpy(tok))
    assert torch.equal(lg, M.forward(params, cfg, torch.from_numpy(tok)))
