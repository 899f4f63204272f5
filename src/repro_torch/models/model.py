"""Model assembly: embeddings -> pattern blocks -> logits, the LM loss,
and serving: prefill into a decode cache and cached decode (the paths
of `repro.models.model`).

Parameters are the reference's tree in PyTorch: ``{"embed",
"final_norm", "segments"}``, where ``segments[i]`` is a list over the
segment's periods of a tuple of block dicts, one per pattern entry (the
reference stacks the periods on a leading axis for ``lax.scan``; here
each period's blocks are their own tensors and `_run_segments` loops
over them). `convert.params_from_jax` maps the reference's tree onto
this one. A decode cache has the same layout: ``{"pos": 0-d int32 on
the device, "segments": [[(block cache, ...) per period] per
segment]}``, mapped by `convert.cache_from_jax` / `cache_to_numpy`.

Entry points:
  forward(mode='train')                  -> logits
  forward(mode='prefill', cache_len=L)   -> (logits, decode-ready cache)
  decode_step                            -> (next-token logits, cache)
  make_cache, lm_loss

Ported: decoder-only LMs whose blocks are 'attn' / 'swa' / 'rglru'
mixers with a 'dense' FFN and RMSNorm or LayerNorm. Cross-attention
('dec', 'xattn'), MLA, MoE FFNs, the xLSTM mixers, encoders, frontends,
MTP, untied heads, sinusoidal positions and rematerialisation raise
`NotImplementedError` (ROADMAP.md §A8).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]
F32 = torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    for pat, _ in cfg.segments():
        for bd in pat:
            if bd.mixer not in ("attn", "swa", "rglru") or bd.ffn != "dense":
                raise NotImplementedError(
                    f"block {bd} is {L.NOT_PORTED}")
    if cfg.norm not in L.NORMS:
        raise NotImplementedError(f"norm {cfg.norm!r} is {L.NOT_PORTED}")
    if cfg.enc_layers or cfg.frontend or cfg.mtp or not cfg.tie_embeddings \
            or not cfg.rope_theta:
        raise NotImplementedError(
            f"{cfg.name}: encoders, frontends, MTP, untied heads and "
            f"sinusoidal positions are {L.NOT_PORTED}")
    if cfg.remat != "none":
        raise NotImplementedError(f"remat={cfg.remat!r} is {L.NOT_PORTED}")


# -- init --------------------------------------------------------------------

def _init_block(gen, bd: BlockDef, cfg: ModelConfig, dtype) -> Params:
    p: Params = {"norm1": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)}
    if bd.mixer in ("attn", "swa"):
        p["mixer"] = L.init_attention(gen, cfg, dtype)
    else:
        p["mixer"] = L.init_rglru_block(gen, cfg, dtype)
    p["norm2"] = L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
    p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters drawn from a `torch.Generator` seeded with `seed`
    on `device` (their values are not the reference's: the tests convert
    the reference's init with `convert.params_from_jax`)."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = cfg.torch_dtype
    return {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model),
                           cfg.d_model ** -0.5, dtype),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "segments": [[tuple(_init_block(gen, bd, cfg, dtype) for bd in pat)
                      for _ in range(n)] for pat, n in cfg.segments()],
    }


# -- caches ------------------------------------------------------------------

def _block_cache(bd: BlockDef, cfg: ModelConfig, b: int, cache_len: int,
                 dtype, device) -> Params:
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    hkv, dh = cfg.num_kv_heads, cfg.hd
    if bd.mixer == "attn":
        return {"k": z(b, hkv, cache_len, dh), "v": z(b, hkv, cache_len, dh)}
    if bd.mixer == "swa":
        w = min(cfg.window, cache_len)
        return {"k": z(b, hkv, w, dh), "v": z(b, hkv, w, dh)}
    if bd.mixer == "rglru":
        w = cfg.rec_width or cfg.d_model
        return {"h": z(b, w), "conv": z(b, 3, w)}
    raise NotImplementedError(f"mixer {bd.mixer!r} is {L.NOT_PORTED}")


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
    if s > cache_len:
        raise ValueError(f"prefill of {s} tokens into a cache of {cache_len}")
    out = {}
    for n, t in kv.items():
        out[n] = t.new_zeros((b, hkv, cache_len, dh))
        out[n][:, :, :s] = t
    return out


# -- blocks and segments -------------------------------------------------

def _apply_block(bd: BlockDef, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, cache: Optional[Params] = None,
                 cache_pos: Optional[torch.Tensor] = None,
                 prefill_len: Optional[int] = None):
    """(x, new_cache). With `prefill_len` (and no cache) builds the
    block's fresh cache; with a cache, decodes one token against it (an
    attention cache is updated in place)."""
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    new_cache = None
    if bd.mixer in ("attn", "swa"):
        window = cfg.window if bd.mixer == "swa" else None
        y, kv = L.attention(p["mixer"], h, cfg, positions, True, window,
                            cache, cache_pos)
        if cache is not None:
            new_cache = kv
        elif prefill_len is not None:
            new_cache = _prefill_kv(kv, window, prefill_len)
        del kv
    elif bd.mixer == "rglru":
        y, new_cache = L.rglru_block(p["mixer"], h, cfg, cache,
                                     return_state=prefill_len is not None)
    else:
        raise NotImplementedError(f"mixer {bd.mixer!r} is {L.NOT_PORTED}")
    x = x + y
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + L.mlp(p["ffn"], h, cfg.activation), new_cache


def _run_segments(params_segs: List, segs, x: torch.Tensor,
                  cfg: ModelConfig, positions: torch.Tensor,
                  cache_segs: Optional[List] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  prefill_len: Optional[int] = None):
    """x through every period of every segment, in order: (x, the new
    caches in the cache layout, or None when none was asked for)."""
    want = cache_segs is not None or prefill_len is not None
    out = []
    for si, (pseg, (pat, _)) in enumerate(zip(params_segs, segs)):
        cseg = None if cache_segs is None else cache_segs[si]
        new_seg = []
        for i, period in enumerate(pseg):
            cper = (None,) * len(pat) if cseg is None else cseg[i]
            new_per = []
            for bd, pp, cc in zip(pat, period, cper):
                x, c = _apply_block(bd, pp, x, cfg, positions, cc, cache_pos,
                                    prefill_len)
                new_per.append(c)
            new_seg.append(tuple(new_per))
        out.append(new_seg)
    return x, (out if want else None)


# -- entry points -------------------------------------------------------

def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    x = params["embed"][tokens.long()] * (cfg.emb_scale or 1.0)
    return x.to(cfg.torch_dtype)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits: the tied head's product accumulates and stays in
    float32 (the reference's ``preferred_element_type=float32``)."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = torch.matmul(x.float(), params["embed"].float().T)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _no_frontend(frontend_embeds) -> None:
    if frontend_embeds is not None:
        raise NotImplementedError(f"frontend embeddings are {L.NOT_PORTED}")


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds=None, mode: str = "train",
            cache_len: Optional[int] = None):
    """mode='train' -> logits (B, S, V) float32; mode='prefill' ->
    (logits, a decode cache of `cache_len` positions holding the S
    prompt tokens, its "pos" S)."""
    _check_ported(cfg)
    _no_frontend(frontend_embeds)
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}")
    if mode == "prefill" and cache_len is None:
        raise ValueError("a prefill needs cache_len")
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x, caches = _run_segments(
        params["segments"], cfg.segments(), _embed(params, cfg, tokens), cfg,
        positions, prefill_len=cache_len if mode == "prefill" else None)
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
    returned."""
    _check_ported(cfg)
    _no_frontend(frontend_embeds)
    pos = cache["pos"]
    x, caches = _run_segments(params["segments"], cfg.segments(),
                              _embed(params, cfg, token), cfg, pos[None],
                              cache["segments"], pos)
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
            targets: torch.Tensor, z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token cross-entropy (+ z-loss) over targets >= 0."""
    return _ce(forward(params, cfg, tokens), targets, z_loss)
