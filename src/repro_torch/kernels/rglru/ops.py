"""`rglru_scan` (the CUDA kernel for CUDA tensors, the plain version for
CPU tensors) and the differentiable `linear_scan`.

Replaces the Pallas kernel `rglru_scan`
(src/repro/kernels/rglru/rglru.py:56). CUDA source:
``kernels/csrc/rglru.cu``: parallel in time as well as in channels. A
CTA owns a slab of channels and walks T in tiles streamed through a
cp.async ring in shared memory; inside a tile each channel's steps are
split over several threads, which scan their sub-chunks, fold the
(prod a, local h) pairs onto the tile's float32 carry and rescan. Bound
on the H100 by bytes (two reads, one write per element).

The backward of a diagonal linear recurrence is itself a reversed one:
given h_t = a_t h_{t-1} + u_t and cotangent g_t,
  dL/du_t = G_t   where  G_t = g_t + a_{t+1} G_{t+1}   (reverse scan)
  dL/da_t = G_t * h_{t-1}
  dL/dh0  = a_1 * G_1
so `linear_scan`'s backward runs the same scan (the kernel on the card)
in reverse mode on the shifted a, as the reference's custom VJP runs it
on time-reversed inputs (src/repro/kernels/rglru/ops.py:47).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rglru.ref import linear_scan_reference
from repro_torch.kernels.wheel._common import (I32, I64, P, bind, launched,
                                               on_cuda, ptr, stream_of)

_ARGS = [P, P, P, I32, I32, I64, I64, I64, P, P, P]
_TYPES = (torch.float32, torch.bfloat16)


def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None, reverse: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (B, T, W), h_T (B, W)) in a's dtype; see
    `linear_scan_reference`. On CUDA: contiguous float32 or bfloat16 a, u
    (B, T, W) and h0 (B, W) of one dtype."""
    if not on_cuda(a):
        return linear_scan_reference(a, u, h0, reverse)
    if a.dim() != 3 or u.shape != a.shape:
        raise ValueError(f"rglru_scan: want a, u of one (B, T, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(u.shape)}")
    b, t, w = a.shape
    named = {"a": a, "u": u}
    if h0 is not None:
        if h0.shape != (b, w):
            raise ValueError(f"rglru_scan: h0 is {tuple(h0.shape)}, want "
                             f"{(b, w)}")
        named["h0"] = h0
    for name, x in named.items():
        if x.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {x.device}, not "
                             f"{a.device}")
        if x.dtype != a.dtype or a.dtype not in _TYPES:
            raise TypeError(f"rglru_scan: {name} has dtype {x.dtype}; want "
                            "float32 or bfloat16, one for all")
        if not x.is_contiguous():
            raise ValueError(f"rglru_scan: {name} is not contiguous")
    h = torch.empty_like(a)
    if b * w == 0:  # nothing to scan: no launch
        return h, a.new_empty((b, w))
    h_last = torch.empty((b, w), dtype=a.dtype, device=a.device)
    fn = bind("rglru", "rt_rglru_scan", _ARGS)
    launched("rglru_scan", fn(
        ptr(a), ptr(u), None if h0 is None else ptr(h0),
        int(a.dtype == torch.bfloat16), int(reverse), b, t, w, ptr(h),
        ptr(h_last), stream_of(a.device)))
    return h, h_last


def _scan(a, u, h0, use_kernel: bool, reverse: bool = False):
    """The kernel at T >= 8 and W >= 8 (the reference's dispatch,
    src/repro/kernels/rglru/ops.py:27); the plain scan otherwise, e.g. a
    decode step's T = 1."""
    kernel = use_kernel and a.shape[1] >= 8 and a.shape[2] >= 8
    return (rglru_scan if kernel else linear_scan_reference)(
        a, u, h0, reverse)


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, u, h0, use_kernel):
        a, u = a.contiguous(), u.contiguous()
        h0 = None if h0 is None else h0.contiguous()
        h, h_last = _scan(a, u, h0, use_kernel)
        ctx.use_kernel = use_kernel
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(a, h, h0 if h0 is not None else a.new_empty(0))
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        b, t, w = a.shape
        if not ctx.has_h0:
            h0 = torch.zeros((b, w), dtype=a.dtype, device=a.device)
        g = g.clone(memory_format=torch.contiguous_format)
        g[:, -1] += g_last
        # reverse scan: G_t = g_t + a_{t+1} G_{t+1}, from t = T - 1 down
        a_next = torch.cat([a[:, 1:], a.new_zeros((b, 1, w))], 1)
        big_g, _ = _scan(a_next, g, None, ctx.use_kernel, reverse=True)
        h_prev = torch.cat([h0[:, None, :], h[:, :-1]], 1)
        da = big_g * h_prev
        dh0 = (a[:, 0] * big_g[:, 0]).to(a.dtype) if ctx.has_h0 else None
        return da.to(a.dtype), big_g.to(a.dtype), dh0, None


def linear_scan(a: torch.Tensor, u: torch.Tensor,
                h0: Optional[torch.Tensor] = None, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + u_t, differentiable in a, u and h0. Returns
    (h (B, T, W), h_last (B, W)). `use_kernel=False`, or T < 8 or W < 8,
    takes the plain scan on every device (forward and backward)."""
    return _LinearScan.apply(a, u, h0, use_kernel)
