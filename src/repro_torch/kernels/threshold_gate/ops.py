"""`threshold_gate(grad, residual, tau)`: error-feedback threshold
compression, the hand-written CUDA kernel for CUDA tensors and the plain
version (`ref.threshold_gate_reference`) for CPU tensors.

Replaces the Pallas kernel `threshold_gate_kernel`
(src/repro/kernels/threshold_gate/threshold_gate.py:36). CUDA source:
``kernels/csrc/threshold_gate.cu``. The Pallas kernel tiles the
flattened tensor in 64k-element blocks, pads the tail, and leaves the
per-block counts for the caller to sum (a TPU has no cross-block
atomics); the CUDA kernel walks the flat tensor with a grid-stride loop
(no padding, so no pad-lane correction) and sums the count on the device
with one atomic per block. Bound on the H100 by bytes: 16 bytes per
float32 element (two reads, two writes). tau is a runtime argument.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.threshold_gate.ref import threshold_gate_reference
from repro_torch.kernels.wheel._common import (F32, I32, I64, P, bind,
                                               launched, on_cuda, ptr,
                                               stream_of)

_ARGS = [P, I32, P, I32, I64, F32, P, P, P, P]
_TYPES = (torch.float32, torch.bfloat16)


def threshold_gate(grad: torch.Tensor, residual: torch.Tensor,
                   tau) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(send, new_residual, n_sent): see `threshold_gate_reference`.
    `n_sent` is a 0-d int32 tensor on the inputs' device (no host sync).
    On CUDA: contiguous float32 or bfloat16 tensors of one shape."""
    if not on_cuda(grad):
        return threshold_gate_reference(grad, residual, tau)
    if residual.device != grad.device:
        raise ValueError(f"threshold_gate: residual is on {residual.device}, "
                         f"grad on {grad.device}")
    if grad.shape != residual.shape:
        raise ValueError(f"threshold_gate: shapes {tuple(grad.shape)} and "
                         f"{tuple(residual.shape)} differ")
    for name, t in (("grad", grad), ("residual", residual)):
        if t.dtype not in _TYPES:
            raise TypeError(f"threshold_gate: {name} has dtype {t.dtype}, "
                            "want float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"threshold_gate: {name} is not contiguous")
    dev = grad.device
    send = torch.empty_like(grad)
    new_res = torch.empty_like(residual)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    fn = bind("threshold_gate", "rt_threshold_gate", _ARGS)
    launched("threshold_gate", fn(
        ptr(grad), int(grad.dtype == torch.bfloat16), ptr(residual),
        int(residual.dtype == torch.bfloat16), grad.numel(), float(tau),
        ptr(send), ptr(new_res), ptr(count), stream_of(dev)))
    return send, new_res, count
