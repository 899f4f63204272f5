"""DELIVER_T staging of the cycle's wheel appends: `stage_rows`.

Each cycle every lane stages one rigid block of rows that (re-)enter a
wheel: window re-entries, then the NDIR send candidates. A data row's
delay is keyed by its *ordinal* (its rank among the live rows of its
lane's block) through the cycle's permutation ``perm`` of 1..10; ALERT
rows are due ``t + 1``. Dead rows are stamped too, so the staged block
is the same bits on every path.

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


def stage_rows_reference(rows: torch.Tensor, alert: torch.Tensor,
                         ordinal: torch.Tensor, perm: torch.Tensor, t: int,
                         dt_col: int) -> torch.Tensor:
    """Plain version: rows (M, ROWW) int64 (uint32 values) with DELIVER_T
    stamped ``t + 1`` where `alert`, else ``t + perm[ordinal mod 10]``
    (floor mod: an ordinal of -1 reads class 9), wrapped to 32 bits."""
    cls = ordinal.long() % NCLASS
    delay = torch.where(alert, 1, perm.long()[cls])
    out = rows.clone()
    out[:, dt_col] = (int(t) + delay) & _M32
    return out


_ARGS = [P, P, P, P, I64, I64, I32, I32, P, P]


def stage_rows(rows: torch.Tensor, alert: torch.Tensor, ordinal: torch.Tensor,
               perm: torch.Tensor, t: int, dt_col: int) -> torch.Tensor:
    """`stage_rows_reference` on the CPU; the CUDA kernel for CUDA tensors
    (rows int64 (M, ROWW), alert bool (M,), ordinal int64 (M,), perm int32
    (10,)); `t` is a host integer."""
    if not on_cuda(rows):
        return stage_rows_reference(rows, alert, ordinal, perm, t, dt_col)
    dev = check_args("stage_rows",
                     dict(rows=rows, alert=alert, ordinal=ordinal, perm=perm),
                     dict(rows=torch.int64, alert=torch.bool,
                          ordinal=torch.int64, perm=torch.int32))
    m, roww = rows.shape
    if alert.shape != (m,) or ordinal.shape != (m,) or perm.shape != (NCLASS,):
        raise ValueError("stage_rows: alert/ordinal must be (M,), perm (10,)")
    if not 0 <= dt_col < roww:
        raise ValueError(f"stage_rows: dt_col {dt_col} outside row width {roww}")
    out = torch.empty_like(rows)
    fn = bind("enqueue", "rt_stage_rows", _ARGS)
    launched("stage_rows", fn(ptr(rows), ptr(alert), ptr(ordinal), ptr(perm),
                              int(t), m, roww, dt_col, ptr(out),
                              stream_of(dev)))
    return out
