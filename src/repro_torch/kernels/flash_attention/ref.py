"""Plain oracle for blockwise attention (causal / sliding-window, GQA):
the reference's `repro.kernels.flash_attention.ref`."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, causal: bool, window: Optional[int],
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask. Query i sits at absolute position
    q_offset + i; key j is visible iff (not causal or j <= pos) and (no
    window or j > pos - window)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None, q_offset: int = 0
                  ) -> torch.Tensor:
    """Grouped-query attention, stable softmax, float32 accumulate.
    q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) -> (B, Hq, Sq, Dv)."""
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    dhv = v.shape[-1]
    g = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    qf = q.float().reshape(b, hkv, g, sq, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / torch.clamp(l, min=1e-30),
                     v.float())
    return o.reshape(b, hq, sq, dhv).to(q.dtype)
