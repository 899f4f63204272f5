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
tangent-half-space cover, P = D + 1, for any D and any cover size M: the
cover in shared memory for D <= 8 and M D <= 12,288 floats, else a
general kernel, whose launches count as "threshold_step_l2_general": a
block stages its rows coalesced into shared memory as float columns and
streams the cover through shared memory in chunks of directions) — and
the wrapper raises for any other problem. One thread per peer; majority
and mean are bound by bytes, L2 by bytes or, for large covers, by its
float operations.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.engine import protocol as proto
from repro_torch.engine.problems import L2Thresh, Majority, MeanMonitor
from repro_torch.kernels.wheel._common import (F32, I32, I64, P, bind,
                                               check_args, launched, on_cuda,
                                               ptr, stream_of)

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
# the shared-memory L2 form's reach (kL2MaxDim, kSmemFloats in the source)
L2_SMEM_MAX_DIM = 8
L2_SMEM_FLOATS = 12_288


def l2_kernel_name(dim: int, ndirs: int) -> str:
    """The L2 kernel a (D, M) problem launches, as its launches count:
    "threshold_step_l2" (the cover in shared memory) or
    "threshold_step_l2_general"."""
    if dim <= L2_SMEM_MAX_DIM and dim * ndirs <= L2_SMEM_FLOATS:
        return "threshold_step_l2"
    return "threshold_step_l2_general"


def l2_general_geometry(dim: int, ndirs: int) -> dict:
    """The general L2 kernel's launch shape for a (D, M) problem, as the
    CUDA source picks it: rows per block, rows staged at a time, columns
    staged at a time (D + 1 unless the columns come in chunks),
    directions per cover chunk, resident (all columns staged once) and
    dynamic shared bytes. Builds the kernels' library on first use."""
    fn = bind("threshold_step", "rt_threshold_step_l2_general_geometry",
              [I32, I32, P])
    out = (ctypes.c_int64 * 6)()
    if fn(dim, ndirs, out) != 0:
        raise ValueError(f"no L2 kernel geometry for D={dim}, M={ndirs}")
    return dict(zip(("rows", "group", "cols", "dirs", "resident",
                     "smem_bytes"), (int(v) for v in out)))


def threshold_step(problem, in_pay: torch.Tensor, out_pay: torch.Tensor,
                   x: torch.Tensor):
    """The plain version on the CPU; on CUDA the problem's kernel, for
    int32 in_pay/out_pay (N,3,P) and x (N,D) (majority, mean: P = 2;
    L2: P = D + 1, any D)."""
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
        name = l2_kernel_name(dw, u.shape[0])
        fn = bind("threshold_step", "rt_" + name, _ARGS_L2)
        launched(name, fn(*common, ptr(u), u.shape[0], dw, float(problem.Tf),
                          n, *outs))
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
