"""`flash_attention_fwd` (the CUDA kernels for CUDA tensors, the plain
pair schedule for CPU tensors), the differentiable `flash_attention`,
and `decode_attention`, one new token against a KV cache.

Replaces the Pallas kernel `flash_attention_fwd`
(src/repro/kernels/flash_attention/flash_attention.py:101). Besides the
decoders' causal and sliding-window self-attention it serves, non-causal,
the encoder's self-attention and cross-attention, where Sq != Skv and the
key length is ragged (1,500 audio frames, 4,100 vision tokens): the
kernel masks the ragged key tile, so nothing is padded. As the Pallas
kernel's ``dhv`` (:116), the value width may differ from the key width:
DeepSeek-V3's MLA prefill attends with q and k 192 wide (128 + 64 rope)
and v 128 wide, at scale 192^-0.5; o is v's width. The reference
sends those shapes to its XLA path (its Pallas kernel takes only
multiples of 128, src/repro/kernels/flash_attention/ops.py:37). CUDA
source:
``kernels/csrc/flash_attention.cu``, two routes by dtype, both visiting
only the visible key tiles and reading kv head h / (Hq / Hkv) without
repeating heads, both writing the per-row log-sum-exp the backward reads:

* bfloat16 (the trainer's and the servers' path): the tensor cores. A
  CTA of two warpgroups owns 128 q rows and streams 64-key K/V tiles
  (each at its own width) through a two-stage cp.async ring in
  128-byte-swizzled shared memory;
  S = Q K^T and O += P V are `wgmma` (P from registers, rounded to
  bf16; V as an MN-major operand), the online softmax stays in
  registers. Bound by operations at the 989 TFLOP/s bf16 rate.
* float32: the CUDA cores (the tensor cores would only give TF32): one
  CTA per 32-row q tile over 32-key tiles, float32 throughout. Bound by
  operations at the 67 TFLOP/s float32 rate.

The backward is the plain FA2 pair schedule (`xla_ref.pair_bwd`) from
the saved (q, k, v, o, lse), as the reference recomputes its backward
through its XLA path (src/repro/kernels/flash_attention/ops.py:57); a
hand-written backward kernel is later work.

`decode_attention` (and `cache_attention`, its core under any mask) is
plain PyTorch in float32, as the reference computes it in XLA outside
Pallas (src/repro/kernels/flash_attention/ops.py:68): one query row a
head against a cache, memory-bound.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.kernels.flash_attention.xla_ref import pair_bwd, pair_fwd
from repro_torch.kernels.wheel._common import (F32, I32, P, bind, launched,
                                               on_cuda, ptr, stream_of)

_ARGS = [P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, F32, I32,
         I32, I32, P]
_TYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)
# the (key width, value width) pairs the kernels are built for: square at
# each of HEAD_DIMS, MLA's (DeepSeek-V3: 128 + 64 rope, 128) and its smoke
# config's (16 + 8, 16)
HEAD_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0):
    """(o (B, Hq, Sq, Dv) in q's dtype, lse (B, Hq, Sq) float32); scale
    defaults to Dqk^-0.5. On CUDA: contiguous q (B, Hq, Sq, Dqk), k (B,
    Hkv, Skv, Dqk) and v (B, Hkv, Skv, Dv) of one dtype (bfloat16,
    16-byte aligned: the tensor-core kernel; float32: the CUDA-core
    kernel), Hq % Hkv == 0, (Dqk, Dv) in `HEAD_PAIRS`."""
    if not on_cuda(q):
        return pair_fwd(q, k, v, causal, window, scale, q_offset)
    b, hq, sq, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh \
            or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if hq % hkv:
        raise ValueError(f"flash_attention_fwd: Hq={hq} is not a multiple "
                         f"of Hkv={hkv}")
    if (dh, dv) not in HEAD_PAIRS:
        raise ValueError(f"flash_attention_fwd: head dims (q/k {dh}, v "
                         f"{dv}) not in {HEAD_PAIRS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_fwd: window {window} <= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}")
        if t.dtype != q.dtype or q.dtype not in _TYPES:
            raise TypeError(f"flash_attention_fwd: {name} has dtype "
                            f"{t.dtype}; want float32 or bfloat16, one for all")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} is not contiguous")
        if q.dtype == torch.bfloat16 and ptr(t) % 16:  # 16-byte copies
            raise ValueError(f"flash_attention_fwd: {name} is not 16-byte "
                             f"aligned")
    if scale is None:
        scale = dh ** -0.5
    o = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = bind("flash_attention", "rt_flash_attention_fwd", _ARGS)
    launched("flash_attention_fwd", fn(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
        int(q.dtype == torch.bfloat16), b, hq, hkv, sq, skv, dh, dv,
        float(scale),
        int(causal), -1 if window is None else int(window), int(q_offset),
        stream_of(q.device)))
    return o, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, fwd):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fwd(q, k, v, causal, window, scale, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, gout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = pair_bwd(q, k, v, o, lse, gout, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    use_kernel: bool = True,
                    fwd: Optional[Callable] = None) -> torch.Tensor:
    """q (B, Hq, Sq, Dqk), k (B, Hkv, Skv, Dqk), v (B, Hkv, Skv, Dv) ->
    (B, Hq, Sq, Dv), differentiable in q, k and v. `use_kernel=False`
    takes the plain forward on every device; `fwd`, a function of
    `flash_attention_fwd`'s signature, stands in for either (the
    backward stays the plain pair schedule)."""
    if fwd is None:
        fwd = flash_attention_fwd if use_kernel else pair_fwd
    return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
                                 fwd)


class SavedFlash:
    """A stand-in for the flash forward (`flash_attention`'s `fwd`) that
    keeps every call's (o, lse) so that a rematerialised forward reads
    them back instead of computing them again: the reference's
    ``save_only_these_names("flash_out")`` under ``jax.checkpoint``
    (src/repro/models/model.py:381). Calls `fwd` and keeps its outputs,
    except inside `replaying()`, where the i-th call returns the i-th
    kept (o, lse) and launches nothing. `contexts` is
    `torch.utils.checkpoint.checkpoint`'s ``context_fn``: the forward
    runs as is, the recompute replays. The kept outputs live as long as
    this object (the checkpoint keeps it until its backward)."""

    def __init__(self, fwd: Callable):
        self.fwd, self.kept, self._next = fwd, [], None

    def __call__(self, q, k, v, causal=True, window=None, scale=None,
                 q_offset=0):
        if self._next is None:
            o, lse = self.fwd(q, k, v, causal, window, scale, q_offset)
            self.kept.append((o.detach(), lse))
            return o, lse
        o, lse = self.kept[self._next]
        self._next += 1
        return o.detach(), lse  # a fresh alias for the new graph node

    @contextlib.contextmanager
    def replaying(self):
        self._next = 0
        try:
            yield
        finally:
            self._next = None

    def contexts(self):
        return contextlib.nullcontext(), self.replaying()


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, valid: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """One query token a head, q (B, Hq, 1, D), against a cache (B, Hkv,
    L, D) where `valid` (B, L) is True; float32 scores, softmax and
    weighted sum, the result in q's dtype."""
    b, hq, _, dh = q.shape
    hkv = k_cache.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, dh)
    sc = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * scale
    sc = torch.where(valid[:, None, None, :], sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, 1, v_cache.shape[-1]).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over a KV cache: q (B, Hq, 1, D),
    caches (B, Hkv, S, D) -> (B, Hq, 1, D). Masks positions >= length
    (B,) (all S when None) and, with a window, positions < length -
    window. The new token's k and v must already be in the cache."""
    s = k_cache.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kpos = torch.arange(s, device=q.device)[None, :]
    if length is None:
        length = torch.full((q.shape[0],), s, dtype=torch.int32,
                            device=q.device)
    valid = kpos < length[:, None]
    if window is not None:
        valid &= kpos >= length[:, None] - window
    return cache_attention(q, k_cache, v_cache, valid, scale)
