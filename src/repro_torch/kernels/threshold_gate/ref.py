"""Plain version of error-feedback threshold compression (the formulas
of `repro.kernels.threshold_gate.ref`).

A coordinate is sent only when its accumulated magnitude crosses tau;
everything below stays in the local residual:

    acc     = grad + residual          (float32)
    send    = where(|acc| >= tau, acc, 0)
    new_res = acc - send               (error feedback: nothing is lost)
    n_sent  = count(|acc| >= tau)      (int32)
"""
from __future__ import annotations

from typing import Tuple

import torch


def threshold_gate_reference(grad: torch.Tensor, residual: torch.Tensor,
                             tau) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(send in grad's dtype, new residual in residual's, n_sent int32)."""
    acc = grad.float() + residual.float()
    mask = acc.abs() >= float(tau)
    send = torch.where(mask, acc, 0.0)
    new_res = acc - send
    nsent = mask.sum(dtype=torch.int32)
    return send.to(grad.dtype), new_res.to(residual.dtype), nsent
