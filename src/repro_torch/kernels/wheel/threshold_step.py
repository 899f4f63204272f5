"""Fused Alg. 3 test/Send step: `threshold_step`.

Computes, per peer, the knowledge K = sum_v X_in + [x, 1], the agreement
A = X_in + X_out, the problem's safe-zone test on (A, K) — the violation
per direction and the output — and the Send payload K - X_in; exactly
`protocol.threshold_rules`, which is the plain version.

Replaces the Pallas kernel `threshold_step_kernel`
(src/repro/kernels/wheel/threshold_step.py:35). CUDA source:
``kernels/csrc/threshold_step.cu``. The Pallas kernel traces any
problem's `test` inside its body; the CUDA kernel of this slice covers
the majority problem (P = 2, D = 1) and raises for any other — the mean
and L2 forms come with the problem slice. On the H100 it is bound by
bytes (about 83 bytes per peer for some 30 integer operations): one
thread per peer, elementwise.
"""
from __future__ import annotations

import torch

from repro_torch.engine import protocol as proto
from repro_torch.engine.problems import Majority
from repro_torch.kernels.wheel._common import (I64, P, bind, check_args,
                                               launched, on_cuda, ptr,
                                               stream_of)


def threshold_step_reference(problem, in_pay: torch.Tensor,
                             out_pay: torch.Tensor, x: torch.Tensor):
    """Plain version: `protocol.threshold_rules` — (viol (N,3) bool,
    output (N,) int32, pay (N,3,P) int32)."""
    return proto.threshold_rules(problem, in_pay, out_pay, x)


_ARGS = [P, P, P, I64, P, P, P, P]


def threshold_step(problem, in_pay: torch.Tensor, out_pay: torch.Tensor,
                   x: torch.Tensor):
    """The plain version on the CPU; on CUDA the majority kernel, for
    int32 in_pay/out_pay (N,3,2) and x (N,1)."""
    if not on_cuda(in_pay):
        return threshold_step_reference(problem, in_pay, out_pay, x)
    if not isinstance(problem, Majority):
        raise NotImplementedError(
            f"threshold_step has a CUDA kernel for the majority problem "
            f"only, not {problem!r} (ROADMAP.md, queue B)")
    dev = check_args("threshold_step",
                     dict(in_pay=in_pay, out_pay=out_pay, x=x),
                     dict(in_pay=torch.int32, out_pay=torch.int32,
                          x=torch.int32))
    n = x.shape[0]
    if in_pay.shape != (n, 3, 2) or out_pay.shape != (n, 3, 2) \
            or x.shape != (n, 1):
        raise ValueError("threshold_step: want in_pay/out_pay (N,3,2), x (N,1)")
    viol = torch.empty((n, 3), dtype=torch.bool, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    pay = torch.empty((n, 3, 2), dtype=torch.int32, device=dev)
    fn = bind("threshold_step", "rt_threshold_step_majority", _ARGS)
    launched("threshold_step", fn(ptr(in_pay), ptr(out_pay), ptr(x), n,
                                  ptr(viol), ptr(out), ptr(pay),
                                  stream_of(dev)))
    return viol, out, pay
