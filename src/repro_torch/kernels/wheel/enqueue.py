"""DELIVER_T staging of the cycle's wheel appends: `stage_rows`.

Each cycle every lane stages one rigid block of rows that (re-)enter a
wheel: window re-entries, then the NDIR send candidates. A data row's
delay is keyed by its *ordinal* (its rank among the live rows of its
lane's block) through the cycle's permutation ``perm`` of 1..10; ALERT
rows are due ``t + 1``. Dead rows are stamped too, so the staged block
is the same bits on every path. A batched engine stages every trial's
blocks in one call, trial-major, each trial with its own permutation
and cycle time (trials frozen at convergence keep their own t).

Replaces the Pallas kernel `stage_rows_kernel`
(src/repro/kernels/wheel/enqueue.py:52). CUDA source:
``kernels/csrc/enqueue.cu``. On the H100 the kernel is bound by bytes
(each int64 row element is read once and written once); it runs one
thread per element so every warp moves contiguous memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wheel._common import (I32, I64, P, bind, check_args,
                                               launched, on_cuda, ptr,
                                               stream_of)

NCLASS = 10
_M32 = 0xFFFFFFFF


def _check_trials(perm: torch.Tensor, t: torch.Tensor, m: int) -> int:
    """B for (B, 10) permutations and (B,) cycle times; the M rows must
    split into B equal trial-major blocks."""
    b = perm.shape[0]
    if perm.shape != (b, NCLASS) or t.shape != (b,) or m % b:
        raise ValueError(f"stage_rows: {m} rows, perm {tuple(perm.shape)} and "
                         f"t {tuple(t.shape)} do not split into equal trials")
    return b


def stage_rows_reference(rows: torch.Tensor, alert: torch.Tensor,
                         ordinal: torch.Tensor, perm: torch.Tensor,
                         t: torch.Tensor, dt_col: int) -> torch.Tensor:
    """Plain version: rows (M, ROWW) int64 (uint32 values) with DELIVER_T
    stamped ``t + 1`` where `alert`, else ``t + perm[ordinal mod 10]``
    (floor mod: an ordinal of -1 reads class 9), wrapped to 32 bits. With
    B trials, `perm` is (B, 10), `t` int32 (B,), and row r is trial
    r // (M / B)'s."""
    m = rows.shape[0]
    b = _check_trials(perm, t, m)
    trial = torch.arange(m, device=rows.device) // max(m // b, 1)
    cls = ordinal.long() % NCLASS
    delay = torch.where(alert, 1, perm.long()[trial, cls])
    out = rows.clone()
    out[:, dt_col] = (t.long()[trial] + delay) & _M32
    return out


_ARGS = [P, P, P, P, P, I64, I64, I32, I32, P, P]


def stage_rows(rows: torch.Tensor, alert: torch.Tensor, ordinal: torch.Tensor,
               perm: torch.Tensor, t: torch.Tensor,
               dt_col: int) -> torch.Tensor:
    """`stage_rows_reference` on the CPU; the CUDA kernel for CUDA tensors
    (rows int64 (M, ROWW), alert bool (M,), ordinal int64 (M,), perm int32
    (B, 10), t int32 (B,): one launch for every trial)."""
    if not on_cuda(rows):
        return stage_rows_reference(rows, alert, ordinal, perm, t, dt_col)
    m, roww = rows.shape
    b = _check_trials(perm, t, m)
    dev = check_args("stage_rows",
                     dict(rows=rows, alert=alert, ordinal=ordinal, perm=perm,
                          t=t),
                     dict(rows=torch.int64, alert=torch.bool,
                          ordinal=torch.int64, perm=torch.int32,
                          t=torch.int32))
    if alert.shape != (m,) or ordinal.shape != (m,):
        raise ValueError("stage_rows: alert/ordinal must be (M,)")
    if not 0 <= dt_col < roww:
        raise ValueError(f"stage_rows: dt_col {dt_col} outside row width {roww}")
    if m * roww > _M32 - 255:  # the kernel's indices are 32-bit
        raise ValueError(f"stage_rows: {m} x {roww} elements, at most 2^32 - "
                         f"256")
    out = torch.empty_like(rows)
    fn = bind("enqueue", "rt_stage_rows", _ARGS)
    launched("stage_rows", fn(ptr(rows), ptr(alert), ptr(ordinal), ptr(perm),
                              ptr(t), max(m // b, 1), m, roww,
                              dt_col, ptr(out), stream_of(dev)))
    return out
