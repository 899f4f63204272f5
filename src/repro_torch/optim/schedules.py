"""LR schedules as scalar-in/scalar-out functions (scale in [0, 1]), in
float32 as the reference's `repro.optim.schedules`; they run on the
host and return a Python float.

Includes WSD (warmup-stable-decay), MiniCPM's schedule, beside the
standard cosine and linear ramps.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def cosine(step, total_steps: int, warmup: int = 0, final: float = 0.1):
    s = _f(step)
    w = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
    prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
    cos = final + (1 - final) * 0.5 * (1 + torch.cos(_f(math.pi) * prog))
    return float(torch.where(s < warmup, w, cos))


def linear(step, total_steps: int, warmup: int = 0, final: float = 0.0):
    s = _f(step)
    w = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
    prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
    return float(torch.where(s < warmup, w, 1.0 - (1.0 - final) * prog))


def wsd(step, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.10, final: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395 §4): linear warmup,
    a long flat stage, then a short cosine decay."""
    s = _f(step)
    wu = max(int(total_steps * warmup_frac), 1)
    dec = max(int(total_steps * decay_frac), 1)
    stable_end = total_steps - dec
    warm = s / wu
    prog = torch.clamp((s - stable_end) / dec, 0.0, 1.0)
    decay = final + (1 - final) * 0.5 * (1 + torch.cos(_f(math.pi) * prog))
    return float(torch.where(s < wu, warm,
                             torch.where(s < stable_end, _f(1.0), decay)))


def get(kind: str):
    return {"cosine": cosine, "linear": linear, "wsd": wsd}[kind]
