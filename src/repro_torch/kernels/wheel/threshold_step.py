"""Fused Alg. 3 test/Send step: `threshold_step`.

Computes, per peer, the knowledge K = sum_v X_in + [x, 1], the agreement
A = X_in + X_out, the problem's safe-zone test on (A, K) — the violation
per direction and the output — and the Send payload K - X_in; exactly
`protocol.threshold_rules`, which is the plain version.

Replaces the Pallas kernel `threshold_step_kernel`
(src/repro/kernels/wheel/threshold_step.py:35). CUDA source:
``kernels/csrc/threshold_step.cu``. The Pallas kernel traces any
problem's `test` inside its body; CUDA has one kernel per problem the
port ships — majority and mean (linear margins, P = 2) and L2 (the
tangent-half-space cover, P = D + 1, the (M, D) cover in shared memory)
— and the wrapper raises for any other problem. On the H100 each is
bound by bytes (one thread per peer, elementwise).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.engine import protocol as proto
from repro_torch.engine.problems import L2Thresh, Majority, MeanMonitor
from repro_torch.kernels.wheel._common import (F32, I32, I64, P, bind,
                                               check_args, launched, on_cuda,
                                               ptr, stream_of)

L2_MAX_DIM = 8                 # the CUDA source instantiates D = 1..8
_SMEM_FLOATS = 48 * 1024 // 4  # static shared-memory budget for the cover


def threshold_step_reference(problem, in_pay: torch.Tensor,
                             out_pay: torch.Tensor, x: torch.Tensor):
    """Plain version: `protocol.threshold_rules` — (viol (N,3) bool,
    output (N,) int32, pay (N,3,P) int32)."""
    return proto.threshold_rules(problem, in_pay, out_pay, x)


# the L2 cover on each device, uploaded once per (problem, device)
_COVERS: "weakref.WeakKeyDictionary[L2Thresh, dict]" = (
    weakref.WeakKeyDictionary())


def _cover(problem: L2Thresh, dev: torch.device) -> torch.Tensor:
    per_dev = _COVERS.setdefault(problem, {})
    u = per_dev.get(dev)
    if u is None:
        u = torch.from_numpy(problem.U).to(dev).contiguous()
        per_dev[dev] = u
    return u


_ARGS_LINEAR = [P, P, P, I32, I32, I64, P, P, P, P]
_ARGS_L2 = [P, P, P, P, I32, I32, F32, I64, P, P, P, P]


def threshold_step(problem, in_pay: torch.Tensor, out_pay: torch.Tensor,
                   x: torch.Tensor):
    """The plain version on the CPU; on CUDA the problem's kernel, for
    int32 in_pay/out_pay (N,3,P) and x (N,D) (majority, mean: P = 2;
    L2: P = D + 1, D <= 8)."""
    if not on_cuda(in_pay):
        return threshold_step_reference(problem, in_pay, out_pay, x)
    if not isinstance(problem, (Majority, MeanMonitor, L2Thresh)):
        raise NotImplementedError(
            f"threshold_step has CUDA kernels for the majority, mean and "
            f"L2 problems, not {problem!r}")
    dev = check_args("threshold_step",
                     dict(in_pay=in_pay, out_pay=out_pay, x=x),
                     dict(in_pay=torch.int32, out_pay=torch.int32,
                          x=torch.int32))
    n, dw, pw = x.shape[0], problem.data_width, problem.payload_width
    if in_pay.shape != (n, 3, pw) or out_pay.shape != (n, 3, pw) \
            or x.shape != (n, dw):
        raise ValueError(f"threshold_step: want in_pay/out_pay (N,3,{pw}), "
                         f"x (N,{dw}) for {problem!r}")
    viol = torch.empty((n, 3), dtype=torch.bool, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    pay = torch.empty((n, 3, pw), dtype=torch.int32, device=dev)
    common = (ptr(in_pay), ptr(out_pay), ptr(x))
    outs = (ptr(viol), ptr(out), ptr(pay), stream_of(dev))
    if isinstance(problem, L2Thresh):
        u = _cover(problem, dev)
        m = u.shape[0]
        if not 1 <= dw <= L2_MAX_DIM or m * dw > _SMEM_FLOATS:
            raise ValueError(
                f"threshold_step: the L2 kernel takes D <= {L2_MAX_DIM} and "
                f"M*D <= {_SMEM_FLOATS} cover floats, got D={dw}, M={m}")
        fn = bind("threshold_step", "rt_threshold_step_l2", _ARGS_L2)
        launched("threshold_step_l2", fn(*common, ptr(u), m, dw,
                                         float(problem.Tf), n, *outs))
    else:  # linear margin a q - b c
        if isinstance(problem, MeanMonitor):
            if not -2**31 <= problem.T < 2**31:
                raise ValueError(
                    f"threshold_step: mean T={problem.T} exceeds int32")
            a, b, name = 1, problem.T, "threshold_step_mean"
        else:
            a, b, name = 2, 1, "threshold_step"
        fn = bind("threshold_step", "rt_threshold_step_linear", _ARGS_LINEAR)
        launched(name, fn(*common, a, b, n, *outs))
    return viol, out, pay
