"""Fused Alg. 3 majority step on (N, 3) counter planes: `majority_step`.

Computes, per peer, the majority test on the unpacked (ones, total)
planes — knowledge, agreement, violation per direction, output and the
Send payload K - X_in — exactly `protocol.majority_rules`, which is the
plain version (`majority_step_reference`).

Replaces the Pallas kernel `majority_step_kernel`
(src/repro/kernels/majority_step/majority_step.py:45). CUDA source:
``kernels/csrc/majority_step.cu``. The Pallas kernel lays the planes out
direction-major, (3, N), so each direction fills the TPU's 128 lanes;
that is a TPU layout choice, and the CUDA kernel keeps the function's
(N, 3) planes with one thread per peer. On the H100 it is bound by bytes
(64 bytes in, 31 out per peer for ~30 integer operations).
"""
from __future__ import annotations

import torch

from repro_torch.engine.protocol import majority_rules
from repro_torch.kernels.wheel._common import (I64, P, bind, check_args,
                                               launched, on_cuda, ptr,
                                               stream_of)


def majority_step_reference(in_ones: torch.Tensor, in_tot: torch.Tensor,
                            out_ones: torch.Tensor, out_tot: torch.Tensor,
                            x: torch.Tensor):
    """Plain version: (viol (N,3) bool, output (N,) int32, pay_ones (N,3),
    pay_tot (N,3)) with pay = K - X_in."""
    viol, output, pay_ones, pay_tot = majority_rules(
        in_ones, in_tot, out_ones, out_tot, x)
    return viol, output.to(torch.int32), pay_ones, pay_tot


_ARGS = [P, P, P, P, P, I64, P, P, P, P, P]


def majority_step(in_ones: torch.Tensor, in_tot: torch.Tensor,
                  out_ones: torch.Tensor, out_tot: torch.Tensor,
                  x: torch.Tensor):
    """The plain version on the CPU; on CUDA the kernel, for contiguous
    int32 planes (N, 3) and votes x (N,)."""
    if not on_cuda(in_ones):
        return majority_step_reference(in_ones, in_tot, out_ones, out_tot, x)
    planes = dict(in_ones=in_ones, in_tot=in_tot, out_ones=out_ones,
                  out_tot=out_tot)
    dev = check_args("majority_step", dict(planes, x=x),
                     {k: torch.int32 for k in (*planes, "x")})
    n = x.shape[0]
    if x.shape != (n,) or any(p.shape != (n, 3) for p in planes.values()):
        raise ValueError("majority_step: want (N,3) planes and x (N,)")
    viol = torch.empty((n, 3), dtype=torch.bool, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    pay_ones = torch.empty((n, 3), dtype=torch.int32, device=dev)
    pay_tot = torch.empty((n, 3), dtype=torch.int32, device=dev)
    fn = bind("majority_step", "rt_majority_step", _ARGS)
    launched("majority_step", fn(
        ptr(in_ones), ptr(in_tot), ptr(out_ones), ptr(out_tot), ptr(x), n,
        ptr(viol), ptr(out), ptr(pay_ones), ptr(pay_tot), stream_of(dev)))
    return viol, out, pay_ones, pay_tot


__all__ = ["majority_step", "majority_step_reference"]
