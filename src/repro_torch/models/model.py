"""Model assembly: embeddings -> pattern blocks -> logits, the LM loss,
and serving: prefill into a decode cache and cached decode (the paths
of `repro.models.model`).

Parameters are the reference's tree in PyTorch: ``{"embed",
"final_norm", "segments"}``, where ``segments[i]`` is a list over the
segment's periods of a tuple of block dicts, one per pattern entry (the
reference stacks the periods on a leading axis for ``lax.scan``; here
each period's blocks are their own tensors and `_run_segments` loops
over them); an untied head adds ``"lm_head"`` (d, V), an encoder
``"enc_segments"`` (laid out by ``cfg.enc_segments()``) and
``"enc_final_norm"``, a frontend narrower or wider than the model
``"frontend_proj"`` (frontend_dim, d). `convert.params_from_jax` maps
the reference's tree onto this one. A decode cache has the same layout:
``{"pos": 0-d int32 on the device, "segments": [[(block cache, ...) per
period] per segment]}``, mapped by `convert.cache_from_jax` /
`cache_to_numpy`; a cross-attention block's cache holds the memory's
keys and values, ``"xk"`` / ``"xv"`` (B, Hkv, M, Dh), from the prefill,
and an MLA block's the compressed latent and rope key, ``"ckv"`` (B, L,
kv_lora_rank) and ``"krope"`` (B, L, qk_rope_dim), no head axis.

Encoder-decoder (Whisper) and cross-attention (Llama-3.2-Vision) models
take frontend-stub embeddings (B, M, frontend_dim): the encoder's
bidirectional blocks turn them into the memory that 'dec' (causal self-
plus cross-attention) blocks attend to, or, without an encoder, they
are projected to d and 'xattn' blocks attend to them. Models without
rotary embeddings (rope_theta 0) add sinusoidal positions.

Entry points:
  forward(mode='train')                  -> logits
  forward(mode='prefill', cache_len=L)   -> (logits, decode-ready cache)
  decode_step                            -> (next-token logits, cache)
  make_cache, lm_loss

Ported: blocks whose mixers are 'attn', 'swa', 'bidir', 'xattn', 'dec',
'mla' (DeepSeek), 'rglru', 'mlstm' or 'slstm' (xLSTM) with a 'dense',
'moe' or 'dense_moe' (Arctic: the MLP and the MoE in parallel) FFN or
none ('none', the xLSTM mLSTM blocks': no ``norm2``, no ``ffn``),
DeepSeek's leading dense layers, RMSNorm or LayerNorm, encoders,
frontend stubs, untied heads, sinusoidal positions, and
rematerialisation (``cfg.remat``: `_run_segments`). An xLSTM block's
decode cache is its recurrent state, float32 in any model dtype: an
mLSTM's ``{"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)}``, an
sLSTM's ``{"c", "n", "h", "m"}`` (B, d each). MTP raises
`NotImplementedError` (ROADMAP.md §A8).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import (SavedFlash,
                                                 flash_attention_fwd,
                                                 pair_fwd)
from repro_torch.models import layers as L

Params = Dict[str, Any]
F32 = torch.float32
MIXERS = ("attn", "swa", "bidir", "xattn", "dec", "mla", "rglru", "mlstm",
          "slstm")
FFNS = ("dense", "moe", "dense_moe", "none")
REMATS = ("none", "block", "block_save_flash")


def _check_ported(cfg: ModelConfig) -> None:
    for pat, _ in cfg.segments() + cfg.enc_segments():
        for bd in pat:
            if bd.mixer not in MIXERS or bd.ffn not in FFNS:
                raise NotImplementedError(
                    f"block {bd} is {L.NOT_PORTED}")
    if cfg.norm not in L.NORMS:
        raise NotImplementedError(f"norm {cfg.norm!r} is {L.NOT_PORTED}")
    if cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: MTP is {L.NOT_PORTED}")
    if cfg.remat not in REMATS:
        raise ValueError(f"remat={cfg.remat!r}; want one of {REMATS}")


# -- init --------------------------------------------------------------------

def _init_block(gen, bd: BlockDef, cfg: ModelConfig, dtype) -> Params:
    norm = lambda: L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
    p: Params = {"norm1": norm()}
    if bd.mixer in ("attn", "swa", "bidir"):
        p["mixer"] = L.init_attention(gen, cfg, dtype)
    elif bd.mixer == "mla":
        p["mixer"] = L.init_mla(gen, cfg, dtype)
    elif bd.mixer == "xattn":
        p["mixer"] = L.init_cross_attention(gen, cfg, dtype)
    elif bd.mixer == "dec":
        p["mixer"] = L.init_attention(gen, cfg, dtype)
        p["cross"] = L.init_cross_attention(gen, cfg, dtype)
        p["norm_cross"] = norm()
    elif bd.mixer == "mlstm":
        p["mixer"] = L.init_mlstm(gen, cfg, dtype)
    elif bd.mixer == "slstm":
        p["mixer"] = L.init_slstm(gen, cfg, dtype)
    else:
        p["mixer"] = L.init_rglru_block(gen, cfg, dtype)
    if bd.ffn == "none":
        return p
    p["norm2"] = norm()
    dense = lambda: L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               dtype)
    if bd.ffn == "dense":
        p["ffn"] = dense()
    else:
        p["ffn"] = L.init_moe(gen, cfg, dtype)
        if bd.ffn == "dense_moe":
            p["ffn_dense"] = dense()
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters drawn from a `torch.Generator` seeded with `seed`
    on `device` (their values are not the reference's: the tests convert
    the reference's init with `convert.params_from_jax`)."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = cfg.torch_dtype
    d = cfg.d_model
    segments = lambda layout: [
        [tuple(_init_block(gen, bd, cfg, dtype) for bd in pat)
         for _ in range(n)] for pat, n in layout]
    p = {"embed": L._normal(gen, (cfg.vocab_size, d), d ** -0.5, dtype),
         "final_norm": L.init_norm(d, cfg.norm, dtype, gen.device),
         "segments": segments(cfg.segments())}
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(gen, (d, cfg.vocab_size), d ** -0.5, dtype)
    if cfg.enc_layers:
        p["enc_segments"] = segments(cfg.enc_segments())
        p["enc_final_norm"] = L.init_norm(d, cfg.norm, dtype, gen.device)
    if cfg.frontend and cfg.frontend_dim and cfg.frontend_dim != d:
        p["frontend_proj"] = L._normal(gen, (cfg.frontend_dim, d),
                                       cfg.frontend_dim ** -0.5, dtype)
    return p


# -- caches ------------------------------------------------------------------

def _block_cache(bd: BlockDef, cfg: ModelConfig, b: int, cache_len: int,
                 dtype, device) -> Params:
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    hkv, dh = cfg.num_kv_heads, cfg.hd
    mt = cfg.n_frontend_tokens
    if bd.mixer in ("attn", "bidir"):
        return {"k": z(b, hkv, cache_len, dh), "v": z(b, hkv, cache_len, dh)}
    if bd.mixer == "swa":
        w = min(cfg.window, cache_len)
        return {"k": z(b, hkv, w, dh), "v": z(b, hkv, w, dh)}
    if bd.mixer == "dec":
        return {"k": z(b, hkv, cache_len, dh), "v": z(b, hkv, cache_len, dh),
                "xk": z(b, hkv, mt, dh), "xv": z(b, hkv, mt, dh)}
    if bd.mixer == "xattn":
        return {"xk": z(b, hkv, mt, dh), "xv": z(b, hkv, mt, dh)}
    if bd.mixer == "mla":
        m = cfg.mla
        return {"ckv": z(b, cache_len, m.kv_lora_rank),
                "krope": z(b, cache_len, m.qk_rope_dim)}
    if bd.mixer == "rglru":
        w = cfg.rec_width or cfg.d_model
        return {"h": z(b, w), "conv": z(b, 3, w)}
    # the xLSTM states: float32 in any model dtype, m from -1e30
    f32 = lambda *shape: torch.zeros(shape, dtype=F32, device=device)
    lowest = lambda *shape: torch.full(shape, -1e30, dtype=F32, device=device)
    if bd.mixer == "mlstm":
        h, dhm = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
        return {"C": f32(b, h, dhm, dhm), "n": f32(b, h, dhm),
                "m": lowest(b, h)}
    if bd.mixer == "slstm":
        d = cfg.d_model
        return {"c": f32(b, d), "n": f32(b, d), "h": f32(b, d),
                "m": lowest(b, d)}
    raise ValueError(f"mixer {bd.mixer!r}")


def make_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> Params:
    """A zeroed decode cache for `batch` sequences of up to `cache_len`
    positions, on `device` (CUDA unless the caller names another)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "segments": [[tuple(_block_cache(bd, cfg, batch, cache_len,
                                             cfg.torch_dtype, dev)
                                for bd in pat) for _ in range(n)]
                         for pat, n in cfg.segments()]}


def _padded(kv: Params, axis: int, cache_len: int) -> Params:
    """Each tensor of `kv` zero-padded along its sequence `axis` to
    `cache_len` positions."""
    out = {}
    for n, t in kv.items():
        s = t.shape[axis]
        if s > cache_len:
            raise ValueError(f"prefill of {s} tokens into a cache of "
                             f"{cache_len}")
        shape = list(t.shape)
        shape[axis] = cache_len
        out[n] = t.new_zeros(shape)
        out[n].narrow(axis, 0, s).copy_(t)
    return out


def _prefill_kv(kv: Params, window: Optional[int], cache_len: int) -> Params:
    """The decode cache of one attention block from the prefill's rotated
    k and v (B, Hkv, S, Dh): with a window, the last ``w = min(window,
    cache_len)`` positions at slots ``pos % w``; else padded to
    `cache_len`."""
    k = kv["k"]
    b, hkv, s, dh = k.shape
    if window is not None:
        w = min(window, cache_len)
        lo = max(0, s - w)
        idx = torch.arange(lo, s, device=k.device) % w
        return {n: t.new_zeros((b, hkv, w, dh)).index_copy_(2, idx, t[:, :, lo:])
                for n, t in kv.items()}
    return _padded(kv, 2, cache_len)


# -- blocks and segments -------------------------------------------------

def _mixer(bd: BlockDef, p: Params, h: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, cache: Optional[Params] = None,
           cache_pos: Optional[torch.Tensor] = None,
           prefill_len: Optional[int] = None, attend=None):
    """(y, new_cache) of a self-attention mixer ('attn', 'swa', 'bidir',
    the self part of 'dec') or an MLA one on the block's normed input h;
    new_cache and `attend` as `_apply_block`'s (new_cache None when
    neither a cache nor `prefill_len` is given)."""
    if bd.mixer == "mla":
        y, kv = L.mla_attention(p["mixer"], h, cfg, positions, cache,
                                cache_pos, attend)
        if cache is None:  # the latent and rope key, padded
            kv = None if prefill_len is None else _padded(kv, 1, prefill_len)
        return y, kv
    window = cfg.window if bd.mixer == "swa" else None
    sc = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    y, kv = L.attention(p["mixer"], h, cfg, positions, bd.mixer != "bidir",
                        window, sc, cache_pos, attend)
    if cache is None:
        # the keys as attention made them (after qk_norm, as a decode step
        # writes them; the reference's 'dec' prefill skips qk_norm:
        # ROADMAP.md §C5)
        kv = None if prefill_len is None else _prefill_kv(kv, window,
                                                           prefill_len)
    return y, kv


def _ffn(bd: BlockDef, p: Params, h: torch.Tensor, cfg: ModelConfig,
         routing: Optional[dict] = None):
    """The FFN's output on the block's normed input h: the MLP, the MoE,
    or ('dense_moe', Arctic) the two in parallel, summed; a MoE writes
    its routing into `routing` (`layers.moe`)."""
    if bd.ffn == "dense":
        return L.mlp(p["ffn"], h, cfg.activation)
    y = L.moe(p["ffn"], h, cfg, routing)
    if bd.ffn == "dense_moe":
        y = L.mlp(p["ffn_dense"], h, cfg.activation) + y
    return y


def _apply_block(bd: BlockDef, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, cache: Optional[Params] = None,
                 cache_pos: Optional[torch.Tensor] = None,
                 prefill_len: Optional[int] = None,
                 memory: Optional[torch.Tensor] = None, attend=None,
                 parts: Optional[dict] = None):
    """(x, new_cache). With `prefill_len` (and no cache) builds the
    block's fresh cache; with a cache, decodes one token against it (an
    attention or MLA cache is updated in place, a recurrent state, the
    RG-LRU's or an xLSTM mixer's, replaced). 'xattn' and 'dec' blocks
    attend to `memory` (B, M, d) when they have no cache. `attend`, a
    function of `flash_attention_fwd`'s signature, stands in for the
    kernel in the block's attention over a sequence. With `parts`, a
    dict, the block writes into it the mixer's output ("mixer", the last
    one added before the FFN), the FFN's normed input ("ffn_in") and
    output ("ffn"), and a MoE's routing ("experts", "keep")."""
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    new_cache = None
    if bd.mixer in ("attn", "swa", "bidir", "dec", "mla"):
        y, new_cache = _mixer(bd, p, h, cfg, positions, cache, cache_pos,
                              prefill_len, attend)
        if bd.mixer == "dec":  # then cross-attention, its own residual
            x = x + y
            h = L.apply_norm(x, p["norm_cross"], cfg.norm)
            xc = None if cache is None else {"k": cache["xk"],
                                             "v": cache["xv"]}
            y, xc = L.cross_attention(p["cross"], h, memory, cfg, False, xc,
                                      attend)
            if new_cache is not None:
                new_cache.update(xk=xc["k"], xv=xc["v"])
    elif bd.mixer == "xattn":
        xc = None if cache is None else {"k": cache["xk"], "v": cache["xv"]}
        y, xc = L.cross_attention(p["mixer"], h, memory, cfg, True, xc,
                                  attend)
        if cache is not None or prefill_len is not None:
            new_cache = {"xk": xc["k"], "xv": xc["v"]}
    else:
        block = {"rglru": L.rglru_block, "mlstm": L.mlstm_block,
                 "slstm": L.slstm_block}[bd.mixer]
        y, new_cache = block(p["mixer"], h, cfg, cache,
                             return_state=prefill_len is not None)
    x = x + y
    if bd.ffn == "none":
        return x, new_cache
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    f = _ffn(bd, p, h, cfg, parts)
    if parts is not None:
        parts.update(mixer=y, ffn_in=h, ffn=f)
    return x + f, new_cache


def _run_segments(params_segs: List, segs, x: torch.Tensor,
                  cfg: ModelConfig, positions: torch.Tensor,
                  cache_segs: Optional[List] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  prefill_len: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None):
    """x through every period of every segment, in order: (x, the new
    caches in the cache layout, or None when none was asked for).

    With ``cfg.remat`` "block" (and no cache asked for, autograd on) each
    period runs under `torch.utils.checkpoint` (non-reentrant): its
    activations are dropped and recomputed in the backward, as the
    reference's ``jax.checkpoint`` of its scan body. "block_save_flash"
    keeps the flash forward's outputs (`SavedFlash`), so the recompute
    does not launch the kernel again (every flash call of the period,
    cross-attention's too, where the reference tags the self-attention
    and MLA outputs only)."""
    want = cache_segs is not None or prefill_len is not None
    remat = cfg.remat != "none" and not want and torch.is_grad_enabled()
    out = []
    for si, (pseg, (pat, _)) in enumerate(zip(params_segs, segs)):
        cseg = None if cache_segs is None else cache_segs[si]
        new_seg = []
        for i, period in enumerate(pseg):
            cper = (None,) * len(pat) if cseg is None else cseg[i]
            if remat:
                x = _remat_period(pat, period, x, cfg, positions, memory)
                continue
            new_per = []
            for bd, pp, cc in zip(pat, period, cper):
                x, c = _apply_block(bd, pp, x, cfg, positions, cc, cache_pos,
                                    prefill_len, memory=memory)
                new_per.append(c)
            new_seg.append(tuple(new_per))
        out.append(new_seg)
    return x, (out if want else None)


def _remat_period(pat, period, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, memory: Optional[torch.Tensor]):
    """One period's blocks on x under `torch.utils.checkpoint` (see
    `_run_segments`)."""
    kw = {"memory": memory}
    context_fn = torch.utils.checkpoint.noop_context_fn
    if cfg.remat == "block_save_flash":
        kw["attend"] = SavedFlash(flash_attention_fwd if cfg.use_kernels
                                  else pair_fwd)
        context_fn = kw["attend"].contexts

    def run(x):
        for bd, pp in zip(pat, period):
            x, _ = _apply_block(bd, pp, x, cfg, positions, **kw)
        return x

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             context_fn=context_fn)


# -- entry points -------------------------------------------------------

def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S, d) float32: sin then cos of positions (S,) over d / 2
    geometric frequencies from 1 to 1 / 10,000. `positions` may be a
    device tensor (a decode step's position): nothing is read back."""
    half, dev = d // 2, positions.device
    step = torch.full((), 10_000.0, device=dev).log() / (half - 1)
    freq = torch.exp(-torch.arange(half, dtype=F32, device=dev) * step)
    ang = positions[:, None].to(F32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _with_positions(x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """x plus sinusoidal positions when the model has no rotary
    embeddings (rope_theta 0), else x."""
    if cfg.rope_theta:
        return x
    return x + _sinusoid(positions, cfg.d_model)[None].to(x.dtype)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor):
    x = params["embed"][tokens.long()] * (cfg.emb_scale or 1.0)
    return _with_positions(x.to(cfg.torch_dtype), cfg, positions)


def _frontend(params: Params, cfg: ModelConfig, frontend_embeds):
    x = frontend_embeds.to(cfg.torch_dtype)
    if "frontend_proj" in params:
        x = L.matmul(x, params["frontend_proj"])
    return x


def _encode(params: Params, cfg: ModelConfig, frontend_embeds):
    """The encoder stack (Whisper) over frontend-stub embeddings."""
    x = _frontend(params, cfg, frontend_embeds)
    mpos = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_segments(params["enc_segments"], cfg.enc_segments(),
                         _with_positions(x, cfg, mpos), cfg, mpos)
    return L.apply_norm(x, params["enc_final_norm"], cfg.norm)


def _memory(params: Params, cfg: ModelConfig, frontend_embeds):
    """What cross-attention attends to: the encoder's output, or the
    projected frontend embeddings; None without embeddings. A model with
    no cross-attention accepts embeddings and leaves them unused."""
    if frontend_embeds is None:
        return None
    if cfg.enc_layers:
        return _encode(params, cfg, frontend_embeds)
    return _frontend(params, cfg, frontend_embeds)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits: the head's product (the untied ``lm_head``, else
    the embedding's transpose) accumulates and stays in float32 (the
    reference's ``preferred_element_type=float32``)."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    head = params.get("lm_head")
    head = params["embed"].T if head is None else head
    logits = torch.matmul(x.float(), head.float())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds=None, mode: str = "train",
            cache_len: Optional[int] = None):
    """mode='train' -> logits (B, S, V) float32; mode='prefill' ->
    (logits, a decode cache of `cache_len` positions holding the S
    prompt tokens, its "pos" S). `frontend_embeds` (B, M, frontend_dim)
    on the tokens' device feed the encoder or the cross-attention
    blocks."""
    _check_ported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}")
    if mode == "prefill" and cache_len is None:
        raise ValueError("a prefill needs cache_len")
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x, caches = _run_segments(
        params["segments"], cfg.segments(),
        _embed(params, cfg, tokens, positions), cfg, positions,
        prefill_len=cache_len if mode == "prefill" else None,
        memory=_memory(params, cfg, frontend_embeds))
    logits = _logits(params, cfg, x)
    if mode == "train":
        return logits
    pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return logits, {"pos": pos, "segments": caches}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, frontend_embeds=None):
    """One decode step: token (B, 1) at position ``cache["pos"]`` ->
    (logits (B, 1, V) float32, cache). The cache is updated in place:
    its attention buffers are written at the new position, its RG-LRU
    states and "pos" (now pos + 1) replaced, and the same dict is
    returned. `frontend_embeds` is accepted, as the reference's is, and
    not read: cross-attention attends to the keys and values its
    prefill cached (the reference encodes the embeddings again and
    discards the result)."""
    _check_ported(cfg)
    del frontend_embeds
    pos = cache["pos"]
    positions = pos[None]
    x, caches = _run_segments(params["segments"], cfg.segments(),
                              _embed(params, cfg, token, positions), cfg,
                              positions, cache["segments"], pos)
    logits = _logits(params, cfg, x)
    cache["segments"], cache["pos"] = caches, pos + 1
    return logits, cache


def _ce(logits: torch.Tensor, targets: torch.Tensor, z_loss: float):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.clamp(targets.long(), min=0)
    picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (targets >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            targets: torch.Tensor, frontend_embeds=None,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token cross-entropy (+ z-loss) over targets >= 0."""
    return _ce(forward(params, cfg, tokens, frontend_embeds), targets,
               z_loss)
