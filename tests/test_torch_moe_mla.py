"""The port's MLA and mixture-of-experts serving path (DeepSeek-V3,
Arctic) against the reference, on the CPU.

Parameters are drawn for each smoke config (float32) in the reference's
layout and converted by `params_from_jax`. The reference initialises
the MoE's selection bias ``router_bias`` to zero, so a port that ignored
it would pass, and its norm weights to one. Every test here first sets each
all-zero leaf from a seeded N(0, 0.5^2) draw, at which the bias changes
which experts the sigmoid router picks (asserted), and each all-one leaf
from a seeded uniform draw on [0.5, 1.5] (`seeded_constant_leaves`).
Inputs are seeded numpy. The reference runs with ``use_pallas=False``,
the port on CPU tensors (its kernels' plain versions). Caches cross by
`cache_to_numpy` / `cache_from_jax`.

Bounds: float32 max |got - want| <= 5e-4 max |want| (tests/
test_torch_decode.py's) for outputs, logits and cache tensors; the plain
flash forward at a value width unlike the key width 1e-5; routing (the
experts picked, the kept slots, the drop count) and `moe_load_stats`
exactly.
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
from repro.kernels.flash_attention.ref import mha_reference as r_mha
from repro.kernels.flash_attention.xla_ref import flash_attention_xla
from repro.models import layers as RL
from repro.models import model as R
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 mha_reference, pair_fwd)
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax, params_to_numpy)
from repro_torch.tree import leaves

ARCHS = ("deepseek-v3-671b", "arctic-480b")
FLASH_BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core (tiny shapes; the thread pools
    of XLA and torch would otherwise spin on the other workers' cores)."""
    with one_core():
        yield


def seeded_constant_leaves(tree, seed: int):
    """`tree` (numpy leaves) with every all-zero leaf (``router_bias``)
    drawn from N(0, 0.5^2) and every all-one leaf (the RMSNorm weights,
    MLA's ``q_norm`` and ``kv_norm`` among them) from U[0.5, 1.5], both
    seeded, in the leaf's shape and dtype; the other leaves as they
    are."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.size and (a == 1).all():
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree.map(fill, tree)


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str):
    """Smoke parameters (float32) in the reference's layout as numpy: the
    port's `init_params` at seed 0 (the same tree as the reference's,
    asserted in `test_params_and_cache_layout_round_trip`; the
    reference's eager init costs ~25 s a config on one core) with its
    constant leaves drawn (seed 5); kept for the file."""
    cfg = registry.get_smoke_config(arch)
    tree = params_to_numpy(M.init_params(cfg, 0, "cpu"), cfg)
    return seeded_constant_leaves(tree, 5)


def reference_model(arch: str):
    """(reference config, port config, reference params, the port's
    converted copy)."""
    rcfg = r_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    tree = _reference_init(arch)
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree,
                                                                       cfg)


def block_of(arch: str, seg: int):
    """(BlockDef, reference block params, the port's) of period 0 of
    segment `seg` (DeepSeek: 0 the leading dense layer, 1 the MoE ones)."""
    rcfg, cfg, jp, params = reference_model(arch)
    bd = cfg.segments()[seg][0][0]
    rblk = jax.tree.map(lambda a: a[0], jp["segments"][seg][0])
    return bd, rblk, params["segments"][seg][0][0]


def tokens_x(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def reference_fns(rcfg, cache_len: int):
    prefill = jax.jit(lambda p, t: R.forward(p, rcfg, t, mode="prefill",
                                             cache_len=cache_len))
    decode = jax.jit(lambda p, t, c: R.decode_step(p, rcfg, t, c))
    forward = jax.jit(lambda p, t: R.forward(p, rcfg, t))
    return prefill, decode, forward


def test_configs_are_the_reference_s():
    """Full and smoke configs field for field (MoEConfig and MLAConfig
    too; the port's `use_kernels` for the reference's `use_pallas`) and
    their segments (DeepSeek's leading dense layers); the full configs'
    widths as published; DeepSeek's MTP head still raises."""
    for arch in ARCHS:
        for get, rget in ((registry.get_config, r_registry.get_config),
                          (registry.get_smoke_config,
                           r_registry.get_smoke_config)):
            a, b = dataclasses.asdict(get(arch)), dataclasses.asdict(rget(arch))
            assert a.pop("use_kernels") and not b.pop("use_pallas")
            assert a == b
            segs = lambda c: [([dataclasses.astuple(bd) for bd in pat], n)
                              for pat, n in c.segments()]
            assert segs(get(arch)) == segs(rget(arch))
    ds, ar = (registry.get_config(a) for a in ARCHS)
    assert (ds.num_layers, ds.d_model, ds.num_heads, ds.first_dense_layers,
            ds.mla.q_lora_rank, ds.mla.kv_lora_rank, ds.mla.qk_nope_dim,
            ds.mla.qk_rope_dim, ds.mla.v_head_dim, ds.moe.n_experts,
            ds.moe.top_k, ds.moe.d_ff, ds.moe.n_shared, ds.moe.router) == (
        61, 7168, 128, 3, 1536, 512, 128, 64, 128, 256, 8, 2048, 1,
        "sigmoid")
    assert [(p[0].ffn, n) for p, n in ds.segments()] == [("dense", 3),
                                                         ("moe", 58)]
    assert (ar.num_layers, ar.d_model, ar.num_heads, ar.num_kv_heads,
            ar.d_ff, ar.moe.n_experts, ar.moe.top_k, ar.moe.d_ff,
            ar.moe.router, ar.pattern[0].ffn) == (
        35, 7168, 56, 8, 4864, 128, 2, 4864, "softmax", "dense_moe")
    mtp = dataclasses.replace(registry.get_smoke_config(ARCHS[0]), mtp=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A8"):
        M.init_params(mtp, 0, "cpu")


# (B, Hq, Hkv, S, Dqk, Dv, causal): MLA's smoke and full widths
@pytest.mark.parametrize("b,hq,hkv,s,dk,dv,causal", [
    (2, 4, 4, 256, 24, 16, True),
    (2, 4, 2, 256, 24, 16, False),     # GQA, non-causal
    (1, 2, 2, 256, 192, 128, True),
    (1, 4, 2, 128, 192, 128, False)])  # GQA, non-causal
def test_plain_flash_with_a_value_width_matches_reference(b, hq, hkv, s, dk,
                                                          dv, causal):
    """`pair_fwd` (the kernel's plain version, what `flash_attention`
    runs on the CPU) and `mha_reference` with v narrower than q and k,
    at scale Dqk^-0.5, against the reference's `flash_attention_xla` and
    `mha_reference`."""
    rng = np.random.default_rng(s + dk)
    q = rng.standard_normal((b, hq, s, dk)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dk)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dv)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want_x = np.asarray(flash_attention_xla(jq, jk, jv, causal))
    want_m = np.asarray(r_mha(jq, jk, jv, causal=causal))
    o, lse = pair_fwd(tq, tk, tv, causal, None, None)
    assert o.shape == (b, hq, s, dv) and lse.shape == (b, hq, s)
    assert rel_err(o.numpy(), want_x) <= FLASH_BOUND
    assert rel_err(o.numpy(), want_m) <= FLASH_BOUND
    assert rel_err(mha_reference(tq, tk, tv, causal).numpy(),
                   want_m) <= FLASH_BOUND
    got = flash_attention(tq, tk, tv, causal, None, dk ** -0.5, 0, True)
    assert torch.equal(got, o)


def reference_latent(rp, x, rcfg, positions, cache_len: int):
    """The reference's MLA prefill cache, made as its `_apply_block`
    makes it (src/repro/models/model.py:269-277) from the mixer's input."""
    m = rcfg.mla
    kv_a = RL.matmul(x, rp["wkv_a"])
    ckv = RL.rms_norm(kv_a[..., :m.kv_lora_rank], rp["kv_norm"]["w"])
    krope = RL.rope(kv_a[..., None, :, m.kv_lora_rank:], positions,
                    rcfg.rope_theta)[:, 0]
    pad = lambda t: jnp.zeros((x.shape[0], cache_len, t.shape[-1]),
                              t.dtype).at[:, :t.shape[1]].set(t)
    return {"ckv": pad(ckv), "krope": pad(krope)}


@pytest.mark.parametrize("s", [12, 128])  # mha_reference; the flash path
def test_mla_attention_prefill_and_decode_match_reference(s):
    """`mla_attention` over a prompt (flash, causal, k's rope part
    broadcast over the heads, scale 24^-0.5), its latent cache against
    the reference's, then 4 decode steps by the absorption form against
    the reference's, output and cache after each."""
    bd, rblk, blk = block_of("deepseek-v3-671b", 1)
    rcfg = r_registry.get_smoke_config("deepseek-v3-671b")
    cfg = registry.get_smoke_config("deepseek-v3-671b")
    x = tokens_x(cfg, 2, s + 4, 21)
    cache_len = s + 6
    pos = np.arange(s)
    want, _ = RL.mla_attention(rblk["mixer"], jnp.asarray(x[:, :s]), rcfg,
                               jnp.asarray(pos))
    got, kv = L.mla_attention(blk["mixer"], torch.from_numpy(x[:, :s]), cfg,
                              torch.from_numpy(pos))
    assert rel_err(got.numpy(), want) <= F32_BOUND
    rc = reference_latent(rblk["mixer"], jnp.asarray(x[:, :s]), rcfg,
                          jnp.asarray(pos), cache_len)
    cache = M._padded(kv, 1, cache_len)
    for n in ("ckv", "krope"):
        assert rel_err(cache[n].numpy(), rc[n]) <= F32_BOUND
    for t in range(s, s + 4):
        want, rc = RL.mla_attention(rblk["mixer"], jnp.asarray(x[:, t:t + 1]),
                                    rcfg, jnp.asarray([t]), cache=rc,
                                    cache_pos=jnp.asarray(t))
        here = torch.tensor(t)
        got, same = L.mla_attention(blk["mixer"],
                                    torch.from_numpy(x[:, t:t + 1]), cfg,
                                    here[None], cache, here)
        assert same is cache
        assert rel_err(got.numpy(), want) <= F32_BOUND, t
        for n in ("ckv", "krope"):
            assert rel_err(cache[n].numpy(), rc[n]) <= F32_BOUND


def reference_routing(rp, x, rcfg):
    """(experts picked, keep) of the reference's `moe` (the 'gather'
    implementation, src/repro/models/layers.py:408-427), spelled out with
    its own operations: `lax.top_k` and the exclusive one-hot prefix
    count."""
    mo = rcfg.moe
    e, k = mo.n_experts, mo.top_k
    xt = x.reshape(-1, x.shape[-1])
    logits = RL.matmul(xt, rp["router"]).astype(jnp.float32)
    if mo.router == "sigmoid":
        sel = jax.nn.sigmoid(logits) + rp["router_bias"][None, :]
    else:
        sel = jax.nn.softmax(logits, axis=-1)
    _, tope = jax.lax.top_k(sel, k)
    cap = int(xt.shape[0] * k / e * mo.capacity_factor) + 1
    flat_e = tope.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    slot = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot,
                               flat_e[:, None], 1)[:, 0]
    return np.asarray(tope), np.asarray(slot < cap)


# the routers, and a capacity factor small enough to drop many pairs
@pytest.mark.parametrize("arch,capacity", [
    ("deepseek-v3-671b", None), ("deepseek-v3-671b", 0.5),
    ("arctic-480b", None), ("arctic-480b", 0.5)])
def test_moe_matches_reference(arch, capacity):
    """`moe` (sigmoid router with its drawn bias + shared expert;
    softmax router) on 2 x 24 tokens against the reference's: the experts
    picked, in order, and the kept (token, slot) pairs exactly (the drop
    count equal; the drawn bias crowds DeepSeek's router, which drops
    pairs at its own capacity factor too; every config drops at 0.5),
    the output within 5e-4."""
    bd, rblk, blk = block_of(arch, 1 if arch.startswith("deepseek") else 0)
    rcfg = r_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    if capacity is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=capacity))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    x = tokens_x(cfg, 2, 24, 31)
    rp, p = rblk["ffn"], blk["ffn"]
    want_e, want_keep = reference_routing(rp, jnp.asarray(x), rcfg)
    tope, gatew, keep, _, cap = L.moe_route(
        p, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(tope.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    drops = int((~keep).sum())
    assert drops == int((~want_keep).sum())
    if capacity is not None:
        assert drops > 0
    if cfg.moe.router == "sigmoid":  # the drawn bias changes the picks
        assert np.abs(p["router_bias"].numpy()).min() > 0
        unbiased = L.top_k(torch.sigmoid(torch.from_numpy(
            x.reshape(-1, cfg.d_model)) @ p["router"]), cfg.moe.top_k)[1]
        assert (unbiased != tope).any()
        assert torch.allclose(gatew.sum(-1), torch.ones(48))
    want = RL.moe(rp, jnp.asarray(x), rcfg)
    got = L.moe(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape
    assert rel_err(got.numpy(), want) <= F32_BOUND


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_load_stats_matches_reference_exactly(arch):
    bd, rblk, blk = block_of(arch, 1 if arch.startswith("deepseek") else 0)
    rcfg = r_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    x = tokens_x(cfg, 3, 20, 41)
    want = np.asarray(RL.moe_load_stats(rblk["ffn"], jnp.asarray(x), rcfg))
    got = L.moe_load_stats(blk["ffn"], torch.from_numpy(x), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 60 * cfg.moe.top_k


def test_top_k_breaks_ties_toward_the_lower_index():
    """Equal scores (the card's bf16 router logits tie) come out in
    index order, the largest first, as `lax.top_k`'s."""
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                  [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = L.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0].tolist() == [1, 3, 0, 2]


@pytest.mark.parametrize("arch,seg", [("arctic-480b", 0),
                                      ("deepseek-v3-671b", 0),
                                      ("deepseek-v3-671b", 1)])
def test_blocks_match_reference(arch, seg):
    """A whole block, its mixer and FFN with their residuals, in the
    train forward and as a prefill with its cache: Arctic's 'dense_moe'
    (GQA attention, the MLP and the MoE in parallel), DeepSeek's leading
    dense MLA block and its MoE one."""
    bd, rblk, blk = block_of(arch, seg)
    rcfg = r_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    assert bd.ffn == {"arctic-480b": "dense_moe"}.get(
        arch, ("dense", "moe")[seg])
    x = tokens_x(cfg, 2, 16, 51)
    pos = np.arange(16)
    rbd = rcfg.segments()[seg][0][0]
    want, want_c = R._apply_block(rbd, rblk, jnp.asarray(x), rcfg,
                                  jnp.asarray(pos), None, None, None, 20)
    got, cache = M._apply_block(bd, blk, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos), prefill_len=20)
    assert rel_err(got.numpy(), want) <= F32_BOUND
    assert sorted(cache) == sorted(want_c)
    for n in cache:
        assert rel_err(cache[n].numpy(), want_c[n]) <= F32_BOUND, n
    train, none = M._apply_block(bd, blk, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos))
    assert none is None and torch.equal(train, got)


@pytest.mark.parametrize("arch,seg", [("arctic-480b", 0),
                                      ("deepseek-v3-671b", 0),
                                      ("deepseek-v3-671b", 1)])
def test_block_parts_and_attend_leave_the_block_as_it_is(arch, seg):
    """`_apply_block`'s `parts` and `attend`, which the card's lockstep
    checks take a block apart with: the block's output and cache are
    bit for bit the same with them; the parts add up to the output; the
    FFN's part is `_ffn` of its recorded input; a MoE's experts and kept
    pairs are the reference's routing of that input; `attend` is called
    once, in the flash kernel's place, at the block's widths (MLA: q and
    k 24 wide, v 16)."""
    bd, rblk, blk = block_of(arch, seg)
    rcfg = r_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    x = torch.from_numpy(tokens_x(cfg, 2, 16, 53))
    pos = torch.arange(16)
    want, want_c = M._apply_block(bd, blk, x, cfg, pos, prefill_len=20)
    calls = []

    def attend(q, k, v, *args):
        calls.append((q.shape[-1], v.shape[-1]))
        return pair_fwd(q, k, v, *args)

    parts = {}
    got, cache = M._apply_block(bd, blk, x, cfg, pos, prefill_len=20,
                                attend=attend, parts=parts)
    assert torch.equal(got, want)
    assert all(torch.equal(cache[n], want_c[n]) for n in want_c)
    assert torch.equal((x + parts["mixer"]) + parts["ffn"], got)
    assert torch.equal(M._ffn(bd, blk, parts["ffn_in"], cfg), parts["ffn"])
    mla = cfg.mla
    assert calls == [(mla.qk_nope_dim + mla.qk_rope_dim, mla.v_head_dim)
                     if bd.mixer == "mla" else (cfg.hd, cfg.hd)]
    if bd.ffn == "dense":
        assert "experts" not in parts
        return
    want_e, want_keep = reference_routing(
        rblk["ffn"], jnp.asarray(parts["ffn_in"].numpy()), rcfg)
    k = cfg.moe.top_k
    np.testing.assert_array_equal(parts["experts"].numpy(),
                                  want_e.reshape(2, 16, k))
    np.testing.assert_array_equal(parts["keep"].numpy(),
                                  want_keep.reshape(2, 16, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_models_serve_against_reference(arch):
    """The whole model: the train forward's logits; then a prefill
    through `launch.steps.make_prefill_step` and 4 greedy steps through
    `make_decode_step` (unchanged: the MLA and MoE blocks run through
    them as they are), logits and every cache tensor (MLA's ckv and
    krope, Arctic's k and v) against the reference's after each; the
    reference's argmax feeds both and the port's equals it. At decode the
    batch is 2 tokens, so DeepSeek's capacity is 1 and pairs drop, as in
    the reference. Last, the cache crosses back through `cache_from_jax`
    and one more step agrees."""
    rcfg, cfg, jp, params = reference_model(arch)
    b, s, cache_len = 2, 12, 20
    tok = prompt(cfg.vocab_size, b, s, 61)
    prefill, decode, forward = reference_fns(rcfg, cache_len)
    assert_logits(M.forward(params, cfg, torch.from_numpy(tok)),
                  forward(jp, jnp.asarray(tok)), F32_BOUND, f"{arch} train")
    want_lg, want_c = prefill(jp, jnp.asarray(tok))
    got_lg, cache = steps.make_prefill_step(cfg, cache_len)(params, tok)
    assert not got_lg.requires_grad
    assert_logits(got_lg, want_lg, F32_BOUND, f"{arch} prefill")
    assert_cache(cache, cfg, want_c, F32_BOUND, f"{arch} prefill")
    names = {n for seg in cache["segments"] for per in seg for c in per
             for n in c}
    assert names == ({"ckv", "krope"} if arch.startswith("deepseek")
                     else {"k", "v"})
    decode_step = steps.make_decode_step(cfg)
    for step in range(4):
        nxt = np.argmax(np.asarray(want_lg[:, -1:]), -1).astype(np.int32)
        assert np.array_equal(nxt, got_lg[:, -1:].argmax(-1).numpy())
        want_lg, want_c = decode(jp, jnp.asarray(nxt), want_c)
        got_lg, cache = decode_step(params, nxt, cache)
        assert_logits(got_lg, want_lg, F32_BOUND, f"{arch} step {step}")
        assert_cache(cache, cfg, want_c, F32_BOUND, f"{arch} step {step}")
    assert int(cache["pos"]) == s + 4
    back = cache_from_jax(jax.tree.map(np.asarray, want_c), cfg)
    for a, w in zip(leaves(cache_to_numpy(back, cfg)),
                    jax.tree.leaves(want_c)):
        np.testing.assert_array_equal(a, np.asarray(w))
    nxt = np.argmax(np.asarray(want_lg[:, -1:]), -1).astype(np.int32)
    want_lg, _ = decode(jp, jnp.asarray(nxt), want_c)
    got_lg, _ = decode_step(params, nxt, back)
    assert_logits(got_lg, want_lg, F32_BOUND, f"{arch} after the round trip")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_layout_round_trip(arch):
    """`params_from_jax` / `params_to_numpy` carry the stacked experts
    (E, d, ff) per period, ``router``, ``router_bias`` (float32 in a
    bfloat16 model), ``shared``, ``ffn_dense``, ``q_norm`` / ``kv_norm``
    and ``lm_head`` bit for bit; `init_params` makes the same tree (its
    experts drawn one at a time) and `make_cache` the reference's
    layout."""
    rcfg, cfg, jp, params = reference_model(arch)
    back = params_to_numpy(params, cfg)
    want = jax.eval_shape(lambda: R.init_params(rcfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(want)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(jp)]
    for a, b in zip(jax.tree.leaves(jp), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    blk = params["segments"][-1][0][0]
    want = {"deepseek-v3-671b": {"router", "router_bias", "w_gate", "w_up",
                                 "w_down", "shared"},
            "arctic-480b": {"router", "router_bias", "w_gate", "w_up",
                            "w_down"}}[arch]
    assert set(blk["ffn"]) == want
    mo = cfg.moe
    assert blk["ffn"]["w_up"].shape == (mo.n_experts, cfg.d_model, mo.d_ff)
    assert blk["ffn"]["w_down"].shape == (mo.n_experts, mo.d_ff, cfg.d_model)
    assert ("ffn_dense" in blk) == (arch == "arctic-480b")
    # the reference's bfloat16 tree: every leaf bfloat16 but the float32
    # router_bias (src/repro/models/layers.py:370)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "router_bias"
        else a.astype(jnp.bfloat16), _reference_init(arch))
    half = params_from_jax(tree, bf)
    hblk = half["segments"][-1][0][0]["ffn"]
    assert hblk["router_bias"].dtype == torch.float32
    assert hblk["w_up"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tree), leaves(params_to_numpy(half, bf))):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    mine = M.init_params(bf, 0, "cpu")
    mblk = mine["segments"][-1][0][0]["ffn"]
    assert mblk["router_bias"].dtype == torch.float32
    assert [tuple(t.shape) for t in leaves(mine)] == \
        [tuple(t.shape) for t in leaves(params)]
    assert mblk["w_up"].std() > 0 and not torch.equal(mblk["w_up"][0],
                                                       mblk["w_up"][1])
    want_c = jax.eval_shape(lambda: R.make_cache(rcfg, 3, 40))
    got_c = M.make_cache(cfg, 3, 40, device="cpu")
    assert [x.shape for x in leaves(cache_to_numpy(got_c, cfg)["segments"])] \
        == [x.shape for x in jax.tree.leaves(want_c["segments"])]
    assert all(not t.any() for t in leaves(got_c["segments"]))


def test_expert_parallel_dispatch_still_raises():
    """The reference's 'ep_a2a' dispatch (expert parallel, ROADMAP.md
    §A8.3) is not ported: `moe` names it."""
    cfg = registry.get_smoke_config("arctic-480b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="ep_a2a"))
    _, _, blk = block_of("arctic-480b", 0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A8"):
        L.moe(blk["ffn"], torch.zeros((1, 4, cfg.d_model)), cfg)
