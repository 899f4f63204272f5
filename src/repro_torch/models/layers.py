"""Model building blocks, functional PyTorch (params are plain dicts):
the subset of `repro.models.layers` that the ported architectures run
(SmolLM-135M, RecurrentGemma-9B).

  * norms: RMSNorm (with optional Gemma-style 1 + w);
  * rotary embeddings;
  * GQA/MQA self-attention, causal or sliding-window, through the
    `flash_attention` kernel (training / prefill form; no decode cache);
  * gated or plain SiLU/GeLU MLPs;
  * the RG-LRU recurrent block (Griffin), through the `rglru_scan` kernel.

Weights keep the reference's (in, out) layout, so a projection is
``x @ w``. Matmuls run in the activation dtype with float32 accumulation
(cuBLAS and the CPU's bf16 GEMM accumulate in float32 and round the
output, as the reference's ``preferred_element_type`` + cast does);
norms, softmax and gates in float32.

Not ported yet (ROADMAP.md §A8): LayerNorm, cross-attention, MLA,
mixture of experts, xLSTM mixers and every decode cache; each raises
`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import linear_scan, rglru_gates

Params = Dict[str, Any]
F32 = torch.float32
NOT_PORTED = "not ported yet (ROADMAP.md §A8)"


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from `gen` (on its device)."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


# -- norms ---------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             unit_offset: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if unit_offset else w.float()
    return (y * scale).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    if kind == "rmsnorm_unit":
        return rms_norm(x, p["w"], unit_offset=True)
    raise NotImplementedError(f"norm {kind!r} is {NOT_PORTED}")


def init_norm(d: int, kind: str, dtype, device) -> Params:
    if kind == "rmsnorm_unit":
        return {"w": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    raise NotImplementedError(f"norm {kind!r} is {NOT_PORTED}")


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


def attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              cache: Optional[Params] = None) -> torch.Tensor:
    """GQA self-attention over x (B, S, d) -> (B, S, d)."""
    if cache is not None:
        raise NotImplementedError(f"attention decode caches are {NOT_PORTED}")
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, s, hq, dh).transpose(1, 2)
    k = _proj(x, p["wk"], p.get("bk")).reshape(b, s, hkv, dh).transpose(1, 2)
    v = _proj(x, p["wv"], p.get("bv")).reshape(b, s, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"]["w"])
        k = rms_norm(k, p["knorm"]["w"])
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    scale = cfg.attn_scale if cfg.attn_scale else dh ** -0.5
    o = flash_attention(q, k, v, causal, window, scale, 0, cfg.use_kernels)
    y = o.transpose(1, 2).reshape(b, s, hq * dh)
    return _proj(y, p["wo"], p.get("bo"))


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


# -- RG-LRU recurrent block (Griffin / RecurrentGemma) -------------------

def init_rglru_block(gen, cfg, dtype) -> Params:
    d, w = cfg.d_model, cfg.rec_width
    nb = cfg.num_heads  # block-diagonal gates, as the official Griffin code
    bw = w // nb
    s = d ** -0.5
    # Lambda init so a in (0.9, 0.999): sigmoid^-1 over that range
    lam = 2.2 + 4.7 * torch.rand((w,), generator=gen, device=gen.device)
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


def _causal_conv4(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, 4 taps, zero history. x: (B, S, W)."""
    s = x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], 3, x.shape[2])), x], dim=1)
    y = sum(xp[:, 3 - i: s + 3 - i] * w[3 - i][None, None, :]
            for i in range(4))
    return y + b[None, None, :]


def rglru_block(p: Params, x: torch.Tensor, cfg,
                cache: Optional[Params] = None) -> torch.Tensor:
    """The RG-LRU mixer over x (B, S, d) -> (B, S, d)."""
    if cache is not None:
        raise NotImplementedError(f"RG-LRU decode caches are {NOT_PORTED}")
    gate = _act(matmul(x, p["w_gate"]), "gelu")
    u = _causal_conv4(matmul(x, p["w_x"]), p["conv_w"], p["conv_b"])
    b_, s_, w_ = u.shape
    nb, bw = p["rg_wa"].shape[0], p["rg_wa"].shape[1]
    ub = u.reshape(b_, s_, nb, bw).float()
    r = torch.einsum("bsnw,nwv->bsnv", ub, p["rg_wa"].float()
                     ).reshape(b_, s_, w_).to(u.dtype)
    i = torch.einsum("bsnw,nwv->bsnv", ub, p["rg_wx"].float()
                     ).reshape(b_, s_, w_).to(u.dtype)
    a_t, u_t = rglru_gates(u, r, i, p["log_lambda"], cfg.rglru_c)
    h, _ = linear_scan(a_t, u_t, None, cfg.use_kernels)
    return matmul(h * gate, p["w_out"])
