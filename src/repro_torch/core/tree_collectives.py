"""Binary-tree collectives over the ranks of a `torch.distributed` group,
from the paper's addressing (the port of `repro.core.tree_collectives`).

The P ranks of a group are peers on a ring with equally-spaced
addresses (rank i owns ((i-1)*S, i*S], S = 2^d / P). For power-of-two P
the induced tree (paper §2) is the PERFECT binary tree, computable
locally by every rank:

    parent(i)  = i - m            if i & (m << 1)   (m = lowbit(i))
                 (i + m) mod P    otherwise          — and parent of the
                 top node 2^(k-1) is the root 0
    children(i = p*2^k)           = i ± 2^(k-1)      (CW / CCW)

which is UP/CW/CCW of `core.addressing` evaluated at address i*S. Each
tree level is two rounds of point-to-point transfers — the CW children,
then the CCW children — one `dist.batch_isend_irecv` a round (the
reference's two `lax.ppermute`s a level):

    tree_reduce      convergecast: leaves->root,  log2(P) levels
    tree_broadcast   root->leaves,                log2(P) levels
    tree_all_reduce  convergecast + broadcast,  2*log2(P) levels

Every rank adds what it receives to its own value in the reference's
order (``own + received``, one addition a round), so the results are
bit-identical to the reference's in every dtype, float32 and bfloat16
included — not merely close to a sum.

Cost model (DESIGN.md §6): latency 2*log2(P)*alpha against a ring's
2*(P-1)*alpha, about twice a ring's bytes for large tensors: for small,
latency-bound tensors (violation votes, alerts, control state).

gloo moves only host tensors through send/recv, so on a gloo group a
CUDA tensor is staged through host memory for each transfer; NCCL moves
device tensors directly.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def _levels(p: int) -> int:
    if p <= 0 or p & (p - 1):
        raise ValueError(f"tree collectives need 2^k ranks, got {p}")
    return p.bit_length() - 1


def _parent(i: int, p: int) -> int:
    m = i & (-i)
    if i == 0:
        return 0
    if i == m and (i << 1) == p:  # top node 2^(k-1) -> root 0
        return 0
    return i - m if i & (m << 1) else (i + m) % p


def _level_nodes(axis_size: int, lvl: int) -> Tuple[List[int], List[int]]:
    """Nodes whose lowbit is 2^lvl (tree depth k - lvl), excluding the
    root, split into CW children (parent = i - m, and the top node) and
    CCW children (parent = i + m): each parent receives from at most one
    of each, so a round has one transfer into any rank."""
    nodes = [
        i for i in range(axis_size)
        if i != 0 and (i & ((1 << (lvl + 1)) - 1)) == (1 << lvl)
    ]
    m = 1 << lvl
    cw = [i for i in nodes if i & (m << 1) or (i << 1) == axis_size]
    ccw = [i for i in nodes if i not in cw]
    return cw, ccw


def _round(x: torch.Tensor, pairs, rank: int, group) -> Optional[torch.Tensor]:
    """One round of transfers ``src -> dst``: this rank sends `x` if it
    is a source and returns what it receives if it is a destination
    (None otherwise). A rank with no transfer in the round touches
    nothing; on gloo only what this rank sends or receives is staged."""
    src = next((s for s, d in pairs if d == rank), None)
    dst = next((d for s, d in pairs if s == rank), None)
    if src is None and dst is None:
        return None
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    home = torch.device("cpu") if stage else x.device
    peer = lambda r: dist.get_global_rank(group or dist.group.WORLD, r)
    ops, recv = [], None
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.to(home).contiguous(), peer(dst),
                              group))
    if src is not None:
        recv = torch.empty(x.shape, dtype=x.dtype, device=home)
        ops.append(dist.P2POp(dist.irecv, recv, peer(src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if recv is not None else None


def _size_rank(group) -> Tuple[int, int]:
    p = dist.get_world_size(group)
    _levels(p)
    return p, dist.get_rank(group)


def tree_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Convergecast sum: the root (rank 0) gets the total; other ranks
    get their subtree's partial sum. Leaves first, two rounds a level
    (paper: messages routed UP accumulate the subtree's knowledge)."""
    p, rank = _size_rank(group)
    for lvl in range(_levels(p)):
        for nodes in _level_nodes(p, lvl):
            got = _round(x, [(i, _parent(i, p)) for i in nodes], rank, group)
            if got is not None:
                x = x + got
    return x


def tree_broadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """The root's value to every rank, top level first."""
    p, rank = _size_rank(group)
    for lvl in reversed(range(_levels(p))):
        for nodes in _level_nodes(p, lvl):
            got = _round(x, [(_parent(i, p), i) for i in nodes], rank, group)
            if got is not None:
                x = got
    return x


def tree_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank gets the sum, in the reference's order of additions."""
    return tree_broadcast(tree_reduce(x, group), group)


def schedule_replay(xs, op: str = "all_reduce"):
    """The reference's schedule replayed on one host: `xs` is every
    rank's value (a list of P tensors); returns every rank's result of
    `op` ("reduce", "broadcast" or "all_reduce"), with the additions of
    the distributed run in its order. The oracle a run on several ranks
    is held to."""
    p = len(xs)
    k = _levels(p)
    xs = list(xs)
    if op in ("reduce", "all_reduce"):
        for lvl in range(k):
            for nodes in _level_nodes(p, lvl):
                sent = {i: xs[i] for i in nodes}
                for i in nodes:
                    par = _parent(i, p)
                    xs[par] = xs[par] + sent[i]
    if op in ("broadcast", "all_reduce"):
        for lvl in reversed(range(k)):
            for nodes in _level_nodes(p, lvl):
                sent = {i: xs[_parent(i, p)] for i in nodes}
                for i in nodes:
                    xs[i] = sent[i]
    return xs
