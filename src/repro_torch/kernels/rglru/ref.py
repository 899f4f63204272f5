"""Plain versions of the RG-LRU diagonal linear recurrence and its gates
(the semantics of `repro.kernels.rglru.ref`).

    h_t = a_t * h_{t-1} + u_t        (or, reversed, a_t * h_{t+1} + u_t)

with a per-(batch, time, width) decay a_t in (0, 1] and a pre-gated
input u_t. The state is float32; outputs are cast back to a's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def linear_scan_reference(a: torch.Tensor, u: torch.Tensor,
                          h0: Optional[torch.Tensor] = None,
                          reverse: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h over time (B, T, W), final state (B, W)).

    A doubling (Hillis-Steele) scan over the composition monoid
    (a1, u1) . (a2, u2) = (a1 a2, u1 a2 + u2): log2(T) whole-tensor passes
    instead of T dependent steps. It rounds differently from a
    sequential loop and from the reference's chunked associative scan;
    every comparison with it states a tolerance.

    `reverse` runs h_t = a_t h_{t+1} + u_t from t = T - 1 down to 0, with
    h0 the state after step T - 1 and the final state h_0: the forward
    scan of the time-flipped inputs, flipped back, with each sum rounded
    in the same order.
    """
    af = a.float()
    uf = u.float()
    first = -1 if reverse else 0
    if h0 is not None:
        uf = uf.clone()
        uf[:, first] += af[:, first] * h0.float()
    t = a.shape[1]
    k = 1
    while k < t:
        if reverse:
            uf = torch.cat([af[:, :-k] * uf[:, k:] + uf[:, :-k], uf[:, -k:]], 1)
            af = torch.cat([af[:, :-k] * af[:, k:], af[:, -k:]], 1)
        else:
            uf = torch.cat([uf[:, :k], uf[:, :-k] * af[:, k:] + uf[:, k:]], 1)
            af = torch.cat([af[:, :k], af[:, :-k] * af[:, k:]], 1)
        k *= 2
    last = 0 if reverse else -1
    return uf.to(a.dtype), uf[:, last].to(a.dtype)


def rglru_gates(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                log_lambda: torch.Tensor, c: float = 8.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU gate math (arXiv:2402.19427): (a_t, u_t) in x's dtype.

    a_t = exp(c * log sigmoid(log_lambda) * sigmoid(r_t))
    u_t = sqrt(1 - a_t^2) * sigmoid(i_t) * x_t
    """
    log_a = c * F.logsigmoid(log_lambda.float())[None, None, :] * torch.sigmoid(
        r.float())
    a_t = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    u_t = mult * torch.sigmoid(i.float()) * x.float()
    return a_t.to(x.dtype), u_t.to(x.dtype)
