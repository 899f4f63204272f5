"""Gossip (LiMoSense-style) parameter averaging, the paper's baseline at
the trainer level (the port's `repro.distributed.gossip_sync`), so that
the two sync families compare on the same footing: the same inner steps
and the same pods.

Each round, pod g averages its replica with pod g XOR 2^(round mod
log2 G): the deterministic finger schedule (a hypercube sweep). After
log2(G) rounds every pod holds the global mean; after fewer, an
approximation. It stands in for the paper's "pick a uniformly random
finger" (§3.2) in SPMD form: a random pairing is no static exchange, and
the hypercube sweep has the same cost a round.

A round moves the whole parameter set: gossip has no violation gate and
no compression, which is why the paper finds it orders of magnitude
dearer at equal accuracy.

Trees here hold the G pods' replicas stacked on a leading axis of every
leaf, on one device, as the reference's. The average is taken in
float32 and cast back to the leaf's dtype: float32 addition and the
halving round alike in both packages, so a round is bit for bit the
reference's.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map

F32 = torch.float32


def partners(round_idx: int, n_pods: int) -> torch.Tensor:
    """Pod g's partner in round `round_idx`: g ^ 2^(round mod log2 G)."""
    if n_pods < 1 or n_pods & (n_pods - 1):
        raise ValueError(f"gossip schedule needs 2^k pods, got {n_pods}")
    k = max(n_pods.bit_length() - 1, 1)
    return torch.arange(n_pods) ^ (1 << (round_idx % k))


def gossip_round(params_g, round_idx: int, n_pods: int):
    """One hypercube-pairwise averaging round over the leading G axis of
    every leaf; a new tree."""
    partner = partners(round_idx, n_pods)

    def avg(t):
        tp = t[partner.to(t.device)]
        return ((t.to(F32) + tp.to(F32)) * 0.5).to(t.dtype)

    return tree_map(avg, params_g)


def agreement_error(params_g) -> torch.Tensor:
    """RMS disagreement across pods (0 when fully synced), a float32
    0-d tensor on the leaves' device."""
    ls = leaves(params_g)
    num = sum(t.numel() // t.shape[0] for t in ls)
    mean_sq = sum(torch.sum(torch.square(
        t.to(F32) - torch.mean(t.to(F32), dim=0, keepdim=True))) for t in ls)
    return torch.sqrt(mean_sq / (num * ls[0].shape[0]))
