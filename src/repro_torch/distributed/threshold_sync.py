"""Threshold-triggered data-parallel synchronization: the paper's local
thresholding at the training level (the reference's
`repro.distributed.threshold_sync`, DESIGN.md §2).

Each pod is a peer; its knowledge K is its locally evolved parameter
replica, the agreement A the last globally synced state. A pod stays
silent while its RMS drift ||K - A|| / sqrt(numel) is at or under tau
and votes for a sync when it is above; a quorum of votes (or the
staleness deadline) triggers the outer sync: the mean pod delta,
optionally error-feedback threshold-compressed by the `threshold_gate`
kernel, drives an outer Nesterov SGD step on the agreement, which every
pod then takes as its parameters.

The reference carries the G pods on a leading axis and `vmap`s the
inner step over it; here the pods are G replicas (a list of parameter
trees) stepped in turn, which computes the same thing on one device.
The steps since the last sync are counted on the host by the trainer
(the reference's outer state carries an unread copy of that count).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.threshold_gate import (threshold_gate,
                                                threshold_gate_reference)
from repro_torch.tree import leaves, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ThresholdSyncConfig:
    tau: float = 0.05  # violation threshold on ||K - A|| / sqrt(numel)
    vote_quorum: float = 0.5  # fraction of pods that must report violation
    outer_lr: float = 0.7  # DiLoCo-style outer SGD
    outer_momentum: float = 0.9
    nesterov: bool = True
    compress_tau: float = 0.0  # 0 => dense sync; >0 => threshold_gate
    max_inner_steps: int = 64  # hard sync deadline (bounded staleness)


def replicate_for_pods(params, n_pods: int) -> List:
    """G independent copies of `params`, one per pod."""
    return [tree_map(torch.clone, params) for _ in range(n_pods)]


def init_outer_state(params, cfg: ThresholdSyncConfig) -> Dict:
    zeros = lambda t: torch.zeros(t.shape, dtype=F32, device=t.device)
    return {"agreement": tree_map(torch.clone, params),
            "momentum": tree_map(zeros, params),
            "residual": tree_map(zeros, params)}


@torch.no_grad()
def drift_and_votes(params_g: List, agreement, cfg: ThresholdSyncConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pod RMS drift (G,) and violation votes (G,) float32 (1.0 where
    the drift exceeds tau), on the parameters' device."""
    flat_a = leaves(agreement)
    num = sum(a.numel() for a in flat_a)
    drift = torch.stack([
        torch.sqrt(sum(torch.sum(torch.square(p.float() - a.float()))
                       for p, a in zip(leaves(pod), flat_a)) / num)
        for pod in params_g])
    return drift, (drift > cfg.tau).to(F32)


def make_sync_step(cfg: ThresholdSyncConfig, use_kernel: bool = True):
    """sync(params_g, outer) -> (params_g, outer, metrics): the mean pod
    delta (threshold-compressed when ``compress_tau > 0``, through the
    `threshold_gate` kernel unless `use_kernel` is False), outer momentum
    SGD on the agreement, and every pod reset to the new agreement (in
    place). metrics: {"sync_sent_bytes": 0-d int64 tensor, 4 bytes per
    sent element}."""
    gate = threshold_gate if use_kernel else threshold_gate_reference

    @torch.no_grad()
    def sync(params_g: List, outer: Dict):
        flat_a = leaves(outer["agreement"])
        pods = [leaves(p) for p in params_g]
        delta = [torch.stack([pod[i].float() - a.float() for pod in pods]
                             ).mean(0) for i, a in enumerate(flat_a)]
        residual = outer["residual"]
        sent = torch.zeros((), dtype=torch.int64, device=flat_a[0].device)
        if cfg.compress_tau > 0.0:
            outs, resids = [], []
            for d, r in zip(delta, leaves(residual)):
                send, nr, cnt = gate(d, r, cfg.compress_tau)
                outs.append(send)
                resids.append(nr)
                sent += cnt
            delta = outs
            residual = unflatten(residual, resids)
        new_a, new_m = [], []
        for a, m, d in zip(flat_a, leaves(outer["momentum"]), delta):
            mom = cfg.outer_momentum * m + d
            upd = cfg.outer_momentum * mom + d if cfg.nesterov else mom
            new_a.append((a.float() + cfg.outer_lr * upd).to(a.dtype))
            new_m.append(mom)
        for pod in pods:
            for p, a in zip(pod, new_a):
                p.copy_(a)
        new_outer = {"agreement": unflatten(outer["agreement"], new_a),
                     "momentum": unflatten(outer["momentum"], new_m),
                     "residual": residual}
        return params_g, new_outer, {"sync_sent_bytes": sent * 4}

    return sync


def should_sync(votes, inner_since_sync: int,
                cfg: ThresholdSyncConfig) -> bool:
    """Host-side decision (votes already fetched): the paper's majority
    rule plus a bounded-staleness deadline."""
    frac = float(np.mean(np.asarray(votes)))
    return (frac >= cfg.vote_quorum
            or int(inner_since_sync) >= cfg.max_inner_steps)
