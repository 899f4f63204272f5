"""Model building blocks, functional PyTorch (params are plain dicts):
the counterparts of `repro.models.layers` that the ten registry
architectures run (SmolLM-135M, RecurrentGemma-9B, Gemma-7B, MiniCPM-2B,
Command-R-35B, DeepSeek-V3, Arctic, xLSTM-350M, Whisper-large-v3,
Llama-3.2-Vision-11B).

  * norms: RMSNorm (with optional Gemma-style 1 + w), LayerNorm;
  * rotary embeddings;
  * GQA/MQA self-attention, causal, bidirectional or sliding-window,
    through the `flash_attention` kernel over a sequence, and against a
    decode cache (`decode_attention`, or the rolling buffer of a sliding
    window) for one new token;
  * cross-attention to a memory (encoder states, vision tokens), through
    the `flash_attention` kernel, non-causal, over a sequence, and
    against its cached keys and values (`decode_attention`) for one new
    token; optionally tanh-gated;
  * DeepSeek's multi-head latent attention (MLA): low-rank q and kv
    compression with decoupled rope, over a sequence through the
    `flash_attention` kernel with keys 192 and values 128 wide, and for
    one new token by the absorption form over the compressed cache
    ``{ckv, krope}`` (plain float32, as the reference's XLA);
  * gated or plain SiLU/GeLU MLPs;
  * mixture of experts (the reference's 'gather' implementation): a
    softmax or sigmoid (+ selection bias) router, top-k with ties to the
    lower expert, static capacity with an overflow bin, the expert
    SwiGLU in float32 a chunk of experts at a time (`expert_swiglu`),
    the gated combine and an optional shared expert; `moe_load_stats`;
    with ``impl="ep_a2a"`` and a mesh set, the expert-parallel
    all-to-all dispatch (`distributed.moe_ep`);
  * the RG-LRU recurrent block (Griffin), through the `rglru_scan` kernel
    over a sequence, with its (h, conv history) state for decode;
  * the xLSTM mixers, plain PyTorch as the reference's XLA: the mLSTM
    (matrix memory, exponential gating) in its stabilised quadratic form
    (S <= 256), its chunkwise form (chunks of 256 carrying (C, n, m))
    and its recurrent form (one token against the cached state), and
    the sLSTM's sequential scan, one token a step.

Weights keep the reference's (in, out) layout, so a projection is
``x @ w``. Matmuls run in the activation dtype with float32 accumulation
(cuBLAS and the CPU's bf16 GEMM accumulate in float32 and round the
output, as the reference's ``preferred_element_type`` + cast does);
norms, softmax and gates in float32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (cache_attention,
                                                 decode_attention,
                                                 flash_attention)
from repro_torch.kernels.rglru import linear_scan, rglru_gates
from repro_torch.models import plan

Params = Dict[str, Any]
F32 = torch.float32
NOT_PORTED = "not ported yet (ROADMAP.md §A8)"


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


class MetaGenerator:
    """`init_params`' generator on the meta device: it draws nothing, so
    every parameter is an empty meta tensor of its shape and dtype."""

    device = torch.device("meta")


def _draws(gen):
    """The generator to pass to a draw (none on the meta device)."""
    return None if isinstance(gen, MetaGenerator) else gen


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from `gen` (on its device)."""
    return (torch.randn(shape, generator=_draws(gen), device=gen.device)
            * scale).to(dtype)


# -- norms ---------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             unit_offset: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if unit_offset else w.float()
    return (y * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


NORMS = ("rmsnorm", "rmsnorm_unit", "layernorm")


def apply_norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    if kind == "rmsnorm_unit":
        return rms_norm(x, p["w"], unit_offset=True)
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    raise ValueError(kind)


def init_norm(d: int, kind: str, dtype, device) -> Params:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "rmsnorm_unit":
        return {"w": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


# -- rotary embeddings ---------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, Dh) with positions (S,); rotate the two halves."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device) / half)
    ang = positions[..., None].to(F32) * freq  # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -- self-attention (GQA) ------------------------------------------------

def init_attention(gen, cfg, dtype) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = d ** -0.5
    p = {
        "wq": _normal(gen, (d, hq * dh), s, dtype),
        "wk": _normal(gen, (d, hkv * dh), s, dtype),
        "wv": _normal(gen, (d, hkv * dh), s, dtype),
        "wo": _normal(gen, (hq * dh, d), s, dtype),
    }
    if cfg.attn_bias:
        z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
        p.update(bq=z(hq * dh), bk=z(hkv * dh), bv=z(hkv * dh), bo=z(d))
    if cfg.qk_norm:
        p.update(qnorm=init_norm(dh, "rmsnorm", dtype, gen.device),
                 knorm=init_norm(dh, "rmsnorm", dtype, gen.device))
    return p


def _proj(x, w, b=None):
    y = matmul(x, w)
    return y + b.to(y.dtype) if b is not None else y


def _heads(y: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(B, S, h * dh) -> (B, h, S, dh). Under the sharding plan, columns
    split over the TP axis across heads' edges are gathered first
    (`plan.whole_heads`)."""
    if plan.is_dtensor(y):
        y = plan.whole_heads(y, h)
    b, s = y.shape[:2]
    return y.reshape(b, s, h, dh).transpose(1, 2)


def _merge_heads(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, h, S, dh) -> (B, S, h * dh), the input of the output
    projection `wo`. Under the sharding plan the gradient coming back is
    first placed as the forward's output (`plan.grad_placed`): the output
    projection's backward hands it over split across heads' edges, which
    the view's backward cannot take; and y is split as wo's rows
    (`plan.rows_of`)."""
    b, h, s, dh = o.shape
    y = o.transpose(1, 2).reshape(b, s, h * dh)
    if not plan.is_dtensor(y):
        return y
    return plan.rows_of(plan.grad_placed(y), wo)


def _attend(q, k, v, causal: bool, window: Optional[int],
            scale: Optional[float], use_kernel: bool, attend=None):
    """`flash_attention` over a sequence; on DTensors (the sharding
    plan), on each rank's own heads (`plan.flash`)."""
    if plan.is_dtensor(q):
        return plan.flash(q, k, v, causal, window, scale, use_kernel, attend)
    return flash_attention(q, k, v, causal, window, scale, 0, use_kernel,
                           attend)


def attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              cache: Optional[Params] = None,
              cache_pos: Optional[torch.Tensor] = None, attend=None):
    """GQA self-attention over x (B, S, d) -> (y (B, S, d), kv).

    Without a cache: `flash_attention` over the sequence; kv is
    ``{"k", "v"}`` (B, Hkv, S, Dh), the rotated keys and values it
    attended over (what a prefill cache keeps). With a cache ``{"k",
    "v"}`` (B, Hkv, L, Dh) and the 0-d position `cache_pos` of the one
    new token (S = 1): its k and v are written at slot ``cache_pos % L``
    in place, it attends over the cache, and kv is that same dict. A
    window's rolling buffer (L == window) holds at slot i the position
    ``pos - ((pos - i) mod L)``, valid iff >= 0; any other cache is
    masked by `decode_attention` at length ``pos + 1`` and the window.
    `attend` (here and in `cross_attention` / `mla_attention`), a
    function of `flash_attention_fwd`'s signature, stands in for the
    kernel over a sequence.
    """
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _heads(_proj(x, p["wq"], p.get("bq")), hq, dh)
    k = _heads(_proj(x, p["wk"], p.get("bk")), hkv, dh)
    v = _heads(_proj(x, p["wv"], p.get("bv")), hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"]["w"])
        k = rms_norm(k, p["knorm"]["w"])
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    scale = cfg.attn_scale if cfg.attn_scale else dh ** -0.5
    if cache is None:
        o = _attend(q, k, v, causal, window, scale, cfg.use_kernels, attend)
        kv = {"k": k, "v": v}
    else:
        if s != 1:
            raise ValueError(f"attention: a decode step takes one token, "
                             f"got {s}")
        kc, vc = cache["k"], cache["v"]
        ln = kc.shape[2]
        if plan.is_dtensor(kc):  # a cache split by the sharding plan
            o = plan.decode_attend(q, k, v, cache, cache_pos, window, scale)
        else:
            slot = torch.remainder(cache_pos, ln).reshape(1).long()
            kc.index_copy_(2, slot, k)
            vc.index_copy_(2, slot, v)
            if window is not None and ln == window:
                slots = torch.arange(ln, device=kc.device)
                valid = cache_pos - torch.remainder(cache_pos - slots,
                                                    ln) >= 0
                o = cache_attention(q, kc, vc, valid.expand(b, ln), scale)
            else:
                length = (cache_pos + 1).to(torch.int32).expand(b)
                o = decode_attention(q, kc, vc, length, window, scale)
        kv = cache
    y = _merge_heads(o, p["wo"])
    return _proj(y, p["wo"], p.get("bo")), kv


# -- cross-attention (GQA) ----------------------------------------------

def init_cross_attention(gen, cfg, dtype) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = d ** -0.5
    return {
        "wq": _normal(gen, (d, hq * dh), s, dtype),
        "wk": _normal(gen, (d, hkv * dh), s, dtype),
        "wv": _normal(gen, (d, hkv * dh), s, dtype),
        "wo": _normal(gen, (hq * dh, d), s, dtype),
        "qnorm": init_norm(dh, "rmsnorm", dtype, gen.device),
        "knorm": init_norm(dh, "rmsnorm", dtype, gen.device),
        "gate_attn": torch.zeros((1,), dtype=dtype, device=gen.device),
    }


def cross_attention(p: Params, x: torch.Tensor,
                    memory: Optional[torch.Tensor], cfg, gated: bool = False,
                    cache: Optional[Params] = None, attend=None):
    """Attention of x (B, S, d) to a memory (B, M, d) -> (y (B, S, d),
    kv). kv is ``{"k", "v"}`` (B, Hkv, M, Dh): the memory's projections
    before the key norm (the reference's cache layout), made here when
    no `cache` is given, else the cache itself. q and k are RMS-normed
    per head; over a sequence the `flash_attention` kernel attends
    non-causally with no padding of M, and one token (S = 1) attends
    through `decode_attention` with no mask (the reference's
    `mha_reference` there). With `gated`, y is scaled by
    ``tanh(gate_attn)``, the gate in float32."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _heads(matmul(x, p["wq"]), hq, dh)
    if cache is None:
        if memory is None:
            raise ValueError("cross-attention needs a memory (frontend "
                             "embeddings) or a cache")
        cache = {n: _heads(matmul(memory, p[w]), hkv, dh).contiguous()
                 for n, w in (("k", "wk"), ("v", "wv"))}
    q = rms_norm(q, p["qnorm"]["w"])
    k = rms_norm(cache["k"], p["knorm"]["w"])
    if s == 1:
        o = decode_attention(q, k, cache["v"])
    else:
        o = _attend(q, k, cache["v"], False, None, None, cfg.use_kernels,
                    attend)
    y = matmul(_merge_heads(o, p["wo"]), p["wo"])
    if gated:
        y = torch.tanh(p["gate_attn"].float()).to(y.dtype) * y
    return y, cache


# -- DeepSeek MLA (multi-head latent attention) ----------------------------

def init_mla(gen, cfg, dtype) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    s = d ** -0.5
    qh = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": _normal(gen, (d, m.q_lora_rank), s, dtype),
        "q_norm": init_norm(m.q_lora_rank, "rmsnorm", dtype, gen.device),
        "wq_b": _normal(gen, (m.q_lora_rank, h * qh), m.q_lora_rank ** -0.5,
                        dtype),
        "wkv_a": _normal(gen, (d, m.kv_lora_rank + m.qk_rope_dim), s, dtype),
        "kv_norm": init_norm(m.kv_lora_rank, "rmsnorm", dtype, gen.device),
        "wkv_b": _normal(gen, (m.kv_lora_rank,
                               h * (m.qk_nope_dim + m.v_head_dim)),
                         m.kv_lora_rank ** -0.5, dtype),
        "wo": _normal(gen, (h * m.v_head_dim, d), (h * m.v_head_dim) ** -0.5,
                      dtype),
    }


def mla_cache_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                        ckv: torch.Tensor, krope: torch.Tensor,
                        wkv_b: torch.Tensor, valid: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """The absorption form over a compressed cache, in float32: q_nope
    (B, H, S, nope) and q_rope (B, H, S, rope) against ckv (B, L, r) and
    krope (B, L, rope) where `valid` (L,) is True; wkv_b (r, H, nope + v)
    folds W_uk into q and W_uv into the output read. -> o (B, H, S, v)
    float32."""
    nope = q_nope.shape[-1]
    w = wkv_b.float()
    kc = ckv.float()
    q_c = torch.einsum("bhsn,rhn->bhsr", q_nope.float(), w[..., :nope])
    sc = torch.einsum("bhsr,blr->bhsl", q_c, kc)
    sc = sc + torch.einsum("bhsr,blr->bhsl", q_rope.float(), krope.float())
    sc = torch.where(valid, sc * scale, -1e30)
    o_c = torch.einsum("bhsl,blr->bhsr", torch.softmax(sc, dim=-1), kc)
    return torch.einsum("bhsr,rhn->bhsn", o_c, w[..., nope:])


def mla_attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                  cache: Optional[Params] = None,
                  cache_pos: Optional[torch.Tensor] = None, attend=None):
    """MLA with decoupled rope over x (B, S, d) -> (y (B, S, d), kv).

    Without a cache: causal `flash_attention` over the sequence, q and k
    ``nope + rope`` wide (k's rope part, one head's, broadcast to every
    head), v ``v_head_dim`` wide, scale (nope + rope)^-0.5; kv is
    ``{"ckv": (B, S, r), "krope": (B, S, rope)}``, the normed latent and
    the rotated rope key (what a prefill cache keeps). With a cache of
    that layout at length L and the 0-d position `cache_pos` of the one
    new token (S = 1): its latent and rope key are written at slot
    `cache_pos` in place, and it attends over slots <= cache_pos by
    `mla_cache_attention`; kv is that same dict."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rdim, vdim, r = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                           m.kv_lora_rank)
    q = matmul(rms_norm(matmul(x, p["wq_a"]), p["q_norm"]["w"]), p["wq_b"])
    q = q.reshape(b, s, h, nope + rdim).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], positions,
                                         cfg.rope_theta)
    kv_a = matmul(x, p["wkv_a"])  # (B, S, r + rope)
    ckv = rms_norm(kv_a[..., :r], p["kv_norm"]["w"])
    k_rope = rope(kv_a[..., r:], positions, cfg.rope_theta)  # (B, S, rope)
    scale = (nope + rdim) ** -0.5
    wkv_b = p["wkv_b"].reshape(r, h, nope + vdim)
    if cache is None:
        heads = lambda w, n: matmul(ckv, w.reshape(r, h * n)).reshape(
            b, s, h, n).transpose(1, 2)
        k_nope = heads(wkv_b[..., :nope], nope)
        v = heads(wkv_b[..., nope:], vdim)
        kk = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, rdim)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        o = _attend(qq, kk, v, True, None, scale, cfg.use_kernels, attend)
        kv = {"ckv": ckv, "krope": k_rope}
    else:
        if s != 1:
            raise ValueError(f"mla_attention: a decode step takes one token, "
                             f"got {s}")
        slot = cache_pos.reshape(1).long()
        cache["ckv"].index_copy_(1, slot, ckv)
        cache["krope"].index_copy_(1, slot, k_rope)
        valid = torch.arange(cache["ckv"].shape[1],
                             device=x.device) <= cache_pos
        o = mla_cache_attention(q_nope, q_rope, cache["ckv"], cache["krope"],
                                wkv_b, valid, scale).to(x.dtype)
        kv = cache
    y = _merge_heads(o, p["wo"])
    return matmul(y, p["wo"]), kv


# -- MLP -------------------------------------------------------------------

def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x.float()).to(x.dtype)
    if kind == "gelu":
        return F.gelu(x.float(), approximate="tanh").to(x.dtype)
    raise ValueError(kind)


def init_mlp(gen, d: int, ff: int, gated: bool, dtype) -> Params:
    p = {"w_up": _normal(gen, (d, ff), d ** -0.5, dtype),
         "w_down": _normal(gen, (ff, d), ff ** -0.5, dtype)}
    if gated:
        p["w_gate"] = _normal(gen, (d, ff), d ** -0.5, dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = matmul(x, p["w_up"])
    if "w_gate" in p:
        up = _act(matmul(x, p["w_gate"]), act) * up
    else:
        up = _act(up, act)
    return matmul(up, p["w_down"])


# -- mixture of experts (static capacity, scatter dispatch) ---------------

# the float32 copies of one chunk of experts' three weight matrices stay
# under this many bytes (a DeepSeek-V3 expert is 176 MB, an Arctic one
# 418 MB; a whole stack would be 15-18 GB a matrix)
EXPERT_CHUNK_BYTES = 1 << 30


def init_moe(gen, cfg, dtype) -> Params:
    mo = cfg.moe
    d, e, ff = cfg.d_model, mo.n_experts, mo.d_ff

    def stack(rows: int, cols: int, scale: float) -> torch.Tensor:
        # drawn one expert at a time: a whole stack drawn in float32
        # would be another copy of it
        w = torch.empty((e, rows, cols), dtype=dtype, device=gen.device)
        for i in range(0 if isinstance(gen, MetaGenerator) else e):
            w[i] = _normal(gen, (rows, cols), scale, dtype)
        return w

    p = {"router": _normal(gen, (d, e), d ** -0.5, dtype),
         # the aux-free balancing bias: float32 in any model dtype
         "router_bias": torch.zeros((e,), dtype=F32, device=gen.device),
         "w_gate": stack(d, ff, d ** -0.5),
         "w_up": stack(d, ff, d ** -0.5),
         "w_down": stack(ff, d, ff ** -0.5)}
    if mo.n_shared:
        p["shared"] = init_mlp(gen, d, mo.d_ff * mo.n_shared, True, dtype)
    return p


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of x, the
    largest first and ties to the lower index (`lax.top_k`'s order,
    which `torch.topk` does not promise): a stable descending sort."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def router_scores(logits: torch.Tensor, cfg) -> torch.Tensor:
    """float32 router scores (T, E) of float32 logits: sigmoid or
    softmax."""
    if cfg.moe.router == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def _router_scores(p: Params, xt: torch.Tensor, cfg) -> torch.Tensor:
    """`router_scores` of the logits rounded to the activation dtype
    first (the reference's `matmul`)."""
    return router_scores(matmul(xt, p["router"]).float(), cfg)


def pick_experts(p: Params, scores: torch.Tensor, cfg):
    """(experts (T, k) int64, gate weights (T, k) float32) of router
    scores (T, E): the sigmoid router adds ``router_bias`` to pick the
    experts only and renormalises the picked scores; the softmax router
    picks by its scores."""
    mo = cfg.moe
    sel = scores + p["router_bias"][None, :] if mo.router == "sigmoid" \
        else scores
    _, tope = top_k(sel, mo.top_k)
    gatew = torch.gather(scores, -1, tope)  # the weights without the bias
    if mo.router == "sigmoid":
        gatew = gatew / torch.clamp(gatew.sum(-1, keepdim=True), min=1e-9)
    return tope, gatew


def queue_slots(ids: torch.Tensor, n: int, valid=None) -> torch.Tensor:
    """Each entry's place in its queue: how many earlier entries have its
    id, one of [0, n) (the exclusive one-hot prefix count); entries not
    `valid` (int32 0 / 1) count for nobody."""
    oh = F.one_hot(ids, n).to(torch.int32)
    if valid is not None:
        oh = oh * valid[:, None]
    before = torch.cumsum(oh, 0, dtype=torch.int32) - oh
    return torch.gather(before, 1, ids[:, None])[:, 0]


def pack_rows(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """rows (N, ...) scattered to rows `idx` of n zero rows; an index of n
    (a dropped row) lands in an overflow row, discarded."""
    buf = rows.new_zeros((n + 1,) + rows.shape[1:])
    return buf.index_copy_(0, idx, rows)[:-1]


def moe_route(p: Params, xt: torch.Tensor, cfg):
    """The routing of tokens xt (T, d): (experts (T, k) int64, gate
    weights (T, k) float32, keep (T * k,) bool, buffer rows (T * k,)
    int64, capacity) (`pick_experts`). Each expert takes at most ``cap =
    int(T k / E * capacity_factor) + 1`` (token, slot) pairs, in
    token-major (t, slot) order; a pair past it is dropped (keep False)
    and its buffer row is the overflow bin E * cap."""
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    tope, gatew = pick_experts(p, _router_scores(p, xt, cfg), cfg)
    cap = int(xt.shape[0] * k / e * mo.capacity_factor) + 1
    flat_e = tope.reshape(-1)
    slot = queue_slots(flat_e, e)
    keep = slot < cap
    buf_idx = torch.where(keep, flat_e * cap + slot, e * cap)
    return tope, gatew, keep, buf_idx, cap


def expert_swiglu(p: Params, xb: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its rows xb (E, C, d), E the experts of
    ``p``'s stacks, in float32 (bf16 operands widened a chunk of experts
    at a time, never a whole stack: `EXPERT_CHUNK_BYTES`), cast to xb's
    dtype: (E, C, d)."""
    e = xb.shape[0]
    out = xb.new_empty(xb.shape)
    per = 4 * sum(p[n][0].numel() for n in ("w_gate", "w_up", "w_down"))
    step = max(1, EXPERT_CHUNK_BYTES // per)
    for e0 in range(0, e, step):
        c = slice(e0, e0 + step)
        xe = xb[c].float()
        up = torch.bmm(xe, p["w_up"][c].float())
        h = F.silu(torch.bmm(xe, p["w_gate"][c].float())) * up
        out[c] = torch.bmm(h, p["w_down"][c].float()).to(xb.dtype)
    return out


def moe(p: Params, x: torch.Tensor, cfg,
        routing: Optional[dict] = None) -> torch.Tensor:
    """Top-k MoE over x (B, S, d) with static capacity and scatter /
    gather dispatch (`moe_route`): the kept (token, slot) copies scatter
    into an (E, cap, d) buffer, each expert's SwiGLU runs on its rows
    (`expert_swiglu`), the results gather back, weighted by their gates
    and summed per token; a dropped pair adds nothing (the residual
    passes through). Plus the shared expert's MLP when the config has
    one. With `routing`, a dict, the experts each token picked
    ("experts", (B, S, k)) and which of its pairs were kept ("keep", (B,
    S, k)) are written into it.

    ``impl="ep_a2a"`` follows the reference's rule
    (src/repro/models/layers.py:390-402): with a mesh set
    (`distributed.moe_ep.set_moe_mesh`) and at least one of this rank's
    tokens per expert rank, the expert-parallel dispatch `moe_ep` (x is
    the rank's own token shard); otherwise (no mesh, or a decode batch
    smaller than the expert group) this gather implementation."""
    mo = cfg.moe
    if mo.impl == "ep_a2a":
        from repro_torch.distributed import moe_ep as EP

        mesh, ax = EP.current_moe_mesh()
        if mesh is not None and x.shape[0] * x.shape[1] >= mesh.shape[ax]:
            return EP.moe_ep(p, x, cfg, routing)
    elif mo.impl != "gather":
        raise ValueError(f"MoE impl {mo.impl!r}; want 'gather' or 'ep_a2a'")
    b, s, d = x.shape
    t, e, k = b * s, mo.n_experts, mo.top_k
    xt = x.reshape(t, d)
    tope, gatew, keep, buf_idx, cap = moe_route(p, xt, cfg)
    if routing is not None:
        routing.update(experts=tope.view(b, s, k), keep=keep.view(b, s, k))
    tok = torch.arange(t * k, device=x.device) // k
    out = expert_swiglu(p, pack_rows(xt[tok], buf_idx, e * cap).view(
        e, cap, d))
    y = out.view(e * cap, d)[torch.clamp(buf_idx, max=e * cap - 1)]
    y = torch.where(keep[:, None], y, 0.0)
    y = y * gatew.reshape(-1)[:, None].to(x.dtype)
    y = y.reshape(t, k, d).sum(1)
    if mo.n_shared:
        y = y + mlp(p["shared"], xt, "silu")
    return y.reshape(b, s, d)


def moe_load_stats(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Per-expert selection counts (E,) int32 (for the aux-free bias
    controller): top-k of scores + ``router_bias`` for either router, as
    the reference's."""
    xt = x.reshape(-1, x.shape[-1])
    sel = _router_scores(p, xt, cfg) + p["router_bias"][None, :]
    _, tope = top_k(sel, cfg.moe.top_k)
    return torch.bincount(tope.reshape(-1), minlength=cfg.moe.n_experts
                          ).to(torch.int32)


# -- RG-LRU recurrent block (Griffin / RecurrentGemma) -------------------

def init_rglru_block(gen, cfg, dtype) -> Params:
    d, w = cfg.d_model, cfg.rec_width
    nb = cfg.num_heads  # block-diagonal gates, as the official Griffin code
    bw = w // nb
    s = d ** -0.5
    # Lambda init so a in (0.9, 0.999): sigmoid^-1 over that range
    lam = 2.2 + 4.7 * torch.rand((w,), generator=_draws(gen),
                                 device=gen.device)
    return {
        "w_x": _normal(gen, (d, w), s, dtype),
        "w_gate": _normal(gen, (d, w), s, dtype),
        "conv_w": _normal(gen, (4, w), 0.25, dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=gen.device),
        "rg_wa": _normal(gen, (nb, bw, bw), bw ** -0.5, dtype),
        "rg_wx": _normal(gen, (nb, bw, bw), bw ** -0.5, dtype),
        "log_lambda": lam,
        "w_out": _normal(gen, (w, d), w ** -0.5, dtype),
    }


def _causal_conv4(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, 4 taps. x: (B, S, W); state: the (B, 3, W)
    history before x (zeros when None). Returns (y, the last 3 inputs)."""
    hist = x.new_zeros((x.shape[0], 3, x.shape[2])) if state is None \
        else state
    xp = torch.cat([hist, x], dim=1)  # (B, S + 3, W)
    s = x.shape[1]
    y = sum(xp[:, 3 - i: s + 3 - i] * w[3 - i][None, None, :]
            for i in range(4))
    return y + b[None, None, :], xp[:, -3:].clone()  # not a view of xp


def rglru_block(p: Params, x: torch.Tensor, cfg,
                cache: Optional[Params] = None, return_state: bool = False):
    """The RG-LRU mixer over x (B, S, d) -> (y (B, S, d), state). With a
    cache ``{"h": (B, W), "conv": (B, 3, W)}`` the scan and the conv
    start from it; state is the new ``{"h", "conv"}`` when a cache was
    given or `return_state` is set (a prefill), else None."""
    gate = _act(matmul(x, p["w_gate"]), "gelu")
    u, conv = _causal_conv4(matmul(x, p["w_x"]), p["conv_w"], p["conv_b"],
                            None if cache is None else cache["conv"])
    b_, s_, w_ = u.shape
    nb, bw = p["rg_wa"].shape[0], p["rg_wa"].shape[1]
    ub = u.reshape(b_, s_, nb, bw).float()
    r = torch.einsum("bsnw,nwv->bsnv", ub, p["rg_wa"].float()
                     ).reshape(b_, s_, w_).to(u.dtype)
    i = torch.einsum("bsnw,nwv->bsnv", ub, p["rg_wx"].float()
                     ).reshape(b_, s_, w_).to(u.dtype)
    a_t, u_t = rglru_gates(u, r, i, p["log_lambda"], cfg.rglru_c)
    h, h_last = linear_scan(a_t, u_t, None if cache is None else cache["h"],
                            cfg.use_kernels)
    y = matmul(h * gate, p["w_out"])
    keep = cache is not None or return_state
    return y, ({"h": h_last, "conv": conv} if keep else None)


# -- xLSTM mixers (mLSTM, sLSTM) ----------------------------------------

def init_mlstm(gen, cfg, dtype) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    up = 2 * d
    s = d ** -0.5
    dev = gen.device
    return {
        "w_up": _normal(gen, (d, up), s, dtype),
        "w_gate": _normal(gen, (d, up), s, dtype),
        "w_q": _normal(gen, (up, up), up ** -0.5, dtype),
        "w_k": _normal(gen, (up, up), up ** -0.5, dtype),
        "w_v": _normal(gen, (up, up), up ** -0.5, dtype),
        "w_if": _normal(gen, (up, 2 * h), s, dtype),  # i, f gates
        # the gates' biases: float32 in any model dtype
        "b_if": torch.cat([torch.zeros((h,), dtype=F32, device=dev),
                           torch.full((h,), 3.0, dtype=F32, device=dev)]),
        "w_down": _normal(gen, (up, d), up ** -0.5, dtype),
        "skip_norm": init_norm(up, "rmsnorm", dtype, dev),
    }


def _neg_inf_above_diagonal(dmat: torch.Tensor) -> torch.Tensor:
    """dmat (..., C, C) with -inf where the key comes after the query
    (the diagonal always survives, so every row's max stays finite)."""
    c = dmat.shape[-1]
    mask = torch.ones((c, c), dtype=torch.bool, device=dmat.device).tril()
    return dmat.masked_fill(~mask, float("-inf"))


def _zero(t: torch.Tensor) -> torch.Tensor:
    """A 0-d zero of t's dtype and device: `torch.maximum` against it
    splits the gradient on ties, as ``jnp.maximum(x, 0.0)`` does
    (`torch.clamp` would pass all of it)."""
    return t.new_zeros(())


def mlstm_inputs(p: Params, x: torch.Tensor, cfg):
    """The mLSTM's projections of x (B, S, d): (gate (B, S, up) in x's
    dtype, q, k, v (B, H, S, dh) float32, log_i, log_f (B, H, S)
    float32). In the reference's rounding order: k is scaled by dh^-0.5
    in the model dtype before the upcast, the gate is SiLU in float32
    cast back, and the gate logits are the rounded product plus the
    float32 bias ``b_if``."""
    b, s, _ = x.shape
    h = cfg.num_heads
    up = p["w_up"].shape[1]
    dh = up // h
    z = matmul(x, p["w_up"])
    gate = F.silu(matmul(x, p["w_gate"]).float()).to(x.dtype)
    heads = lambda w: matmul(z, w).reshape(b, s, h, dh).transpose(1, 2)
    # dh^-0.5 rounded to the model dtype first, as a weak-typed Python
    # scalar is in the reference
    k = heads(p["w_k"]) * torch.tensor(dh ** -0.5, dtype=x.dtype)
    ifg = matmul(z, p["w_if"]).float() + p["b_if"]
    log_i = ifg[..., :h].transpose(1, 2)
    log_f = F.logsigmoid(ifg[..., h:]).transpose(1, 2)
    return (gate, heads(p["w_q"]).float(), k.float(),
            heads(p["w_v"]).float(), log_i, log_f)


def mlstm_parallel(q, k, v, log_i, log_f, return_state: bool = False):
    """The stabilised quadratic (parallel) form: q, k, v (B, H, S, dh)
    float32 (k scaled), log_i, log_f (B, H, S) -> (h (B, H, S, dh), the
    final ``{"C", "n", "m"}`` when `return_state`, else None)."""
    cf = torch.cumsum(log_f, -1)
    dmat = _neg_inf_above_diagonal(cf[..., :, None] - cf[..., None, :]
                                   + log_i[..., None, :])
    m = torch.maximum(torch.amax(dmat, -1), _zero(dmat))
    w = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.exp(dmat - m[..., None])
    norm = torch.maximum(torch.abs(w.sum(-1)), torch.exp(-m))
    o = torch.einsum("bhqk,bhkd->bhqd", w, v) / norm[..., None]
    if not return_state:
        return o, None
    # C_S = sum_j exp(cf_S - cf_j + li_j - m_C) k_j v_j^T
    wj = cf[..., -1:] - cf + log_i
    m_c = torch.maximum(torch.amax(wj, -1), _zero(wj))
    wexp = torch.exp(wj - m_c[..., None])
    return o, {"C": torch.einsum("bhs,bhsd,bhse->bhde", wexp, k, v),
               "n": torch.einsum("bhs,bhsd->bhd", wexp, k), "m": m_c}


# the chunkwise form halves its chunk while it does not divide S, as the
# reference does, but not below this: where the reference's chunk falls
# under it (to 1 at an odd S, a scan of S steps) the port takes chunks
# of this many positions and a shorter last one
MIN_CHUNK = 64


def mlstm_chunked(q, k, v, log_i, log_f, chunk: int = 256):
    """The chunkwise-parallel form: the quadratic form inside chunks of
    `chunk` positions (halved while it does not divide S, down to
    `MIN_CHUNK`; then the last chunk is shorter), the stabilised state
    (C, n, m) carried across them; the same stabiliser as the quadratic
    form (m_t = max(inter, intra, 0)), exact for any chunk length.
    Arguments as `mlstm_parallel`'s; returns (h (B, H, S, dh), the final
    ``{"C", "n", "m"}``)."""
    b, h, s, dh = q.shape
    c = chunk
    while s % c and c > MIN_CHUNK:
        c //= 2
    cm = q.new_zeros((b, h, dh, dh))
    n = q.new_zeros((b, h, dh))
    ms = q.new_full((b, h), -1e30)
    outs = []
    for t0 in range(0, s, c):
        part = slice(t0, t0 + c)
        qq, kk, vv = q[:, :, part], k[:, :, part], v[:, :, part]
        li = log_i[..., part]
        bcum = torch.cumsum(log_f[..., part], -1)  # inclusive local decay
        btot = bcum[..., -1]
        dmat = _neg_inf_above_diagonal(bcum[..., :, None]
                                       - bcum[..., None, :] + li[..., None, :])
        m_inter = bcum + ms[..., None]
        m_t = torch.maximum(torch.maximum(torch.amax(dmat, -1), m_inter),
                            _zero(dmat))
        w = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * torch.exp(
            dmat - m_t[..., None])
        inter = torch.exp(m_inter - m_t)
        num = torch.einsum("bhqk,bhkd->bhqd", w, vv) + inter[..., None] \
            * torch.einsum("bhqd,bhde->bhqe", qq, cm)
        den = w.sum(-1) + inter * torch.einsum("bhqd,bhd->bhq", qq, n)
        outs.append(num / torch.maximum(torch.abs(den),
                                        torch.exp(-m_t))[..., None])
        # the state at the chunk's end
        wj = btot[..., None] - bcum + li
        m_new = torch.maximum(torch.maximum(btot + ms, torch.amax(wj, -1)),
                              _zero(wj))
        carry = torch.exp(btot + ms - m_new)
        wexp = torch.exp(wj - m_new[..., None])
        cm = carry[..., None, None] * cm + torch.einsum(
            "bhs,bhsd,bhse->bhde", wexp, kk, vv)
        n = carry[..., None] * n + torch.einsum("bhs,bhsd->bhd", wexp, kk)
        ms = m_new
    return torch.cat(outs, 2), {"C": cm, "n": n, "m": ms}


def mlstm_step(state: Params, q, k, v, log_i, log_f):
    """The recurrent form, one token: state ``{"C": (B, H, dh, dh), "n":
    (B, H, dh), "m": (B, H)}`` float32, q, k, v (B, H, 1, dh) float32,
    log_i, log_f (B, H, 1) -> (h (B, H, 1, dh), the new state)."""
    cm, n, m_prev = state["C"].float(), state["n"].float(), state["m"]
    li, lf = log_i[..., 0], log_f[..., 0]
    m_new = torch.maximum(lf + m_prev, li)
    fi = torch.exp(lf + m_prev - m_new)[..., None]
    ii = torch.exp(li - m_new)[..., None]
    k1, v1, q1 = k[:, :, 0], v[:, :, 0], q[:, :, 0]
    cm = fi[..., None] * cm + ii[..., None] * torch.einsum("bhd,bhe->bhde",
                                                           k1, v1)
    n = fi * n + ii * k1
    num = torch.einsum("bhd,bhde->bhe", q1, cm)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q1, n)),
                        torch.exp(-m_new))
    return (num / den[..., None])[:, :, None], {"C": cm, "n": n, "m": m_new}


def mlstm_block(p: Params, x: torch.Tensor, cfg,
                cache: Optional[Params] = None, return_state: bool = False):
    """The mLSTM mixer (xLSTM): matrix memory, exponential gating, over x
    (B, S, d) -> (y (B, S, d), state). Without a cache: the quadratic
    form for S <= 256, the chunkwise form (`mlstm_chunked`, chunk 256)
    beyond; state is
    the final ``{"C", "n", "m"}`` (float32) when `return_state` (a
    prefill), else None. With a cache (S = 1): the recurrent form, and
    state is the new cache."""
    b, s, _ = x.shape
    gate, q, k, v, log_i, log_f = mlstm_inputs(p, x, cfg)
    if cache is not None:
        if s != 1:
            raise ValueError(f"mlstm_block: a decode step takes one token, "
                             f"got {s}")
        o, state = mlstm_step(cache, q, k, v, log_i, log_f)
    elif s > 256:
        o, state = mlstm_chunked(q, k, v, log_i, log_f, 256)
    else:
        o, state = mlstm_parallel(q, k, v, log_i, log_f, return_state)
    if cache is None and not return_state:
        state = None
    y = o.transpose(1, 2).reshape(b, s, -1).to(x.dtype)
    y = rms_norm(y, p["skip_norm"]["w"]) * gate
    return matmul(y, p["w_down"]), state


def init_slstm(gen, cfg, dtype) -> Params:
    d = cfg.d_model
    s = d ** -0.5
    return {
        "w_gates": _normal(gen, (d, 4 * d), s, dtype),  # i, f, z, o
        "r_gates": _normal(gen, (d, 4 * d), s, dtype),  # recurrent
        "b_gates": torch.zeros((4 * d,), dtype=F32, device=gen.device),
        "w_out": _normal(gen, (d, d), s, dtype),
    }


def slstm_block(p: Params, x: torch.Tensor, cfg,
                cache: Optional[Params] = None, return_state: bool = False):
    """The sLSTM mixer (xLSTM): scalar memory, exponential gating and a
    stabiliser, over x (B, S, d) -> (y (B, S, d), state): a sequential
    scan, one token a step, from the cache ``{"c", "n", "h", "m"}`` (each
    (B, d) float32) or from zeros (m from -1e30). state is the final
    ``{"c", "n", "h", "m"}`` when a cache was given or `return_state` is
    set (a prefill), else None. The recurrent h is rounded to the model
    dtype before each product with ``r_gates``, as the reference's."""
    b, s, d = x.shape
    wx = matmul(x, p["w_gates"]).float() + p["b_gates"]  # (B, S, 4d)
    if cache is None:
        c, n, hs = (wx.new_zeros((b, d)) for _ in range(3))
        m = wx.new_full((b, d), -1e30)
    else:
        c, n, hs, m = (cache[k].float() for k in ("c", "n", "h", "m"))
    one = wx.new_ones(())
    outs = []
    for t in range(s):
        # the product rounds to the model dtype, then widens in the add
        g = torch.add(wx[:, t], matmul(hs.to(x.dtype), p["r_gates"]))
        ig, fg, zg, og = g.chunk(4, -1)
        lfm = F.logsigmoid(fg) + m
        m_new = torch.maximum(lfm, ig)
        i_ = torch.exp(ig - m_new)
        f_ = torch.exp(lfm - m_new)
        c = f_ * c + i_ * torch.tanh(zg)
        n = f_ * n + i_
        hs = torch.sigmoid(og) * c / torch.maximum(n, one)
        m = m_new
        outs.append(hs)
    y = matmul(torch.stack(outs, 1).to(x.dtype), p["w_out"])
    keep = cache is not None or return_state
    return y, ({"c": c, "n": n, "h": hs, "m": m} if keep else None)
