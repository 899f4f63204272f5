"""Model assembly: embeddings -> pattern blocks -> logits, and the LM loss
(the training path of `repro.models.model`).

Parameters are the reference's tree in PyTorch: ``{"embed",
"final_norm", "segments"}``, where ``segments[i]`` is a list over the
segment's periods of a tuple of block dicts, one per pattern entry (the
reference stacks the periods on a leading axis for ``lax.scan``; here
each period's blocks are their own tensors and `_run_segments` loops
over them). `convert.params_from_jax` maps the reference's tree onto
this one.

Ported: decoder-only LMs whose blocks are 'attn' / 'swa' / 'rglru'
mixers with a 'dense' FFN, in `forward(mode="train")` and `lm_loss`.
Prefill and decode, encoders, frontends, MTP and rematerialisation raise
`NotImplementedError` (ROADMAP.md §A8).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]
F32 = torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    for pat, _ in cfg.segments():
        for bd in pat:
            if bd.mixer not in ("attn", "swa", "rglru") or bd.ffn != "dense":
                raise NotImplementedError(
                    f"block {bd} is {L.NOT_PORTED}")
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


# -- blocks and segments -------------------------------------------------

def _apply_block(bd: BlockDef, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    if bd.mixer in ("attn", "swa"):
        window = cfg.window if bd.mixer == "swa" else None
        y = L.attention(p["mixer"], h, cfg, positions, True, window)
    elif bd.mixer == "rglru":
        y = L.rglru_block(p["mixer"], h, cfg)
    else:
        raise NotImplementedError(f"mixer {bd.mixer!r} is {L.NOT_PORTED}")
    x = x + y
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + L.mlp(p["ffn"], h, cfg.activation)


def _run_segments(params_segs: List, segs, x: torch.Tensor,
                  cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """x through every period of every segment, in order."""
    for pseg, (pat, _) in zip(params_segs, segs):
        for period in pseg:
            for bd, pp in zip(pat, period):
                x = _apply_block(bd, pp, x, cfg, positions)
    return x


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


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            mode: str = "train") -> torch.Tensor:
    """mode='train' -> logits (B, S, V) float32."""
    if mode != "train":
        raise NotImplementedError(f"forward mode {mode!r} is {L.NOT_PORTED}")
    _check_ported(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _run_segments(params["segments"], cfg.segments(),
                      _embed(params, cfg, tokens), cfg, positions)
    return _logits(params, cfg, x)


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
