"""The model under the sharding plan: what DTensor needs in the model's
path, where its own sharding propagation would fail, be wrong, or move
far more than it must.

The reference lays its parameters out for GSPMD and compiles one
program for the whole mesh; the port places the same trees as DTensors
(`distributed.sharding.distribute`) and runs the model's own code on
them, eager. Most ops propagate their placements by DTensor's rules;
a few places get help here, each taken only when its input is a DTensor,
so a plain tensor's path is unchanged in value and launches:

  * `stream` and `residual`: the residual stream whole over the TP axis
    (split over its batch only) before each block and the head, and
    each block's mixer and FFN outputs reduced to that layout before
    they are added to it (Megatron's all-reduces);
  * `vocab_embed`: the vocab-parallel embedding, a masked lookup of the
    rank's rows summed over the vocab's axis (DTensor's own sharding of
    an index into a vocab-split table fails or moves the table);
  * `flash`: the attention core on each rank's own heads (and batch)
    through `local_map`, so the flash kernel, which takes raw pointers,
    runs on the local shards; grouped KV heads that the TP axis splits
    finer than they go are repeated first, so each rank's query heads
    find their KV head locally; where the axis does not divide the
    heads, each rank takes its share of the (batch row, KV head) groups;
  * `decode_attend`: one new token against a cache sharded over its
    heads, or over its sequence (when the KV heads do not divide): the
    owning rank writes the token, each rank attends over its slots, and
    the partial softmaxes combine across the axis (flash-decoding);
  * `vocab_ce`: the cross-entropy over vocab-sharded logits: each rank's
    log-sum-exp combined across the axis, and the target's logit picked
    by the rank that holds it.

Plain tensors that meet DTensors in the model's code (positions, rotary
frequencies) are taken as replicated: `mesh_context` opens DTensor's
implicit replication for a step.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from repro_torch.kernels.flash_attention import flash_attention

TP = "model"
BATCH_AXES = ("pod", "data")


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def mesh_context(leaf):
    """The context a step on `leaf`'s tree runs in: DTensor's implicit
    replication of plain tensors for a DTensor, else nothing."""
    return implicit_replication() if is_dtensor(leaf) else \
        contextlib.nullcontext()


def _offset(t: DTensor, dim: int) -> int:
    """Where this rank's shard of `t` starts along `dim`."""
    from repro_torch.distributed.sharding import local_shape
    return local_shape(t.shape, t.device_mesh, t.placements)[1][dim]


def _batch_of(t: DTensor, dim: int = 0):
    """`t`'s placements kept where they split its batch `dim` over a
    batch axis, Replicate elsewhere."""
    names = t.device_mesh.mesh_dim_names
    return [p if n in BATCH_AXES and p == Shard(dim) else Replicate()
            for n, p in zip(names, t.placements)]


def _tp_dim(mesh) -> Optional[int]:
    names = mesh.mesh_dim_names
    return names.index(TP) if TP in names else None


def stream(x):
    """The residual stream x (B, S, d) before a block and before the
    head: under the plan split over its batch only, whole on every rank
    of the TP axis (the Megatron layout; DTensor's own propagation would
    leave it a partial sum or split over d, and every product after it
    would reshuffle its weights instead); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _batch_of(x))


def residual(x, y):
    """x + y, a block's mixer or FFN output y added to the residual
    stream x: under the plan y, a partial sum over the TP axis after its
    row-split product, is first placed as x (reduced over the axis, as
    Megatron's all-reduce after the row-parallel product), and the
    sum's gradient is reduced to that layout on the way back (where the
    norm's backward left it a partial sum). Left to DTensor, either
    would stay partial, and the products that meet it would gather their
    weights and each rank would compute every column."""
    if is_dtensor(x) and is_dtensor(y):
        return grad_placed(x + y.redistribute(x.device_mesh, x.placements))
    return x + y


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward places the gradient as the forward's
    output was placed."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.place = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.place)


def grad_placed(x: DTensor) -> DTensor:
    """x, with its gradient redistributed to x's placements on the way
    back (before the backward of the op that made x)."""
    return _GradPlaced.apply(x)


def whole_heads(y: DTensor, h: int) -> DTensor:
    """y (..., h * dh) with its last dim split over the TP axis into
    whole heads: kept when the axis divides h, else gathered (every
    rank then holds all h heads)."""
    ti = _tp_dim(y.device_mesh)
    if ti is None or y.placements[ti] != Shard(y.dim() - 1) \
            or h % y.device_mesh.shape[ti] == 0:
        return y
    place = list(y.placements)
    place[ti] = Replicate()
    return y.redistribute(y.device_mesh, place)


def rows_of(y: DTensor, w) -> DTensor:
    """y (..., n) for ``y @ w``, w (n, m): where w's rows are split over
    the TP axis and y's last dim is whole over it (attention whose heads
    the axis did not split), y's last dim split the same way, a slice of
    each rank's own columns; so the product and its weight's gradient
    each take the rank's rows (left to DTensor, the backward would
    compute the whole weight's gradient on every rank). Else y."""
    ti = _tp_dim(y.device_mesh)
    if ti is None or not is_dtensor(w) or w.placements[ti] != Shard(0) \
            or y.placements[ti] != Replicate():
        return y
    place = list(y.placements)
    place[ti] = Shard(y.dim() - 1)
    return y.redistribute(y.device_mesh, place)


# -- embedding ---------------------------------------------------------------

def vocab_embed(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """``table[tokens]`` with the table's rows (the vocab) split over
    the TP axis: each rank looks up the tokens in its rows (zero for the
    others), and the sum over the axis is the embedding, replicated over
    it; batch-split as `tokens`."""
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    off = _offset(table, 0)
    rows = Shard(0)

    def lookup(tab, tok):
        idx = tok.long() - off
        ok = (idx >= 0) & (idx < tab.shape[0])
        e = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                         device=e.device))

    batch = _batch_of(tokens)
    out = [b if b != Replicate() else Partial() if t == rows else b
           for b, t in zip(batch, table.placements)]
    # a rank's table gradient comes from its own batch: a partial sum
    # over the batch's axes
    grad = [Partial() if b == Shard(0) else t
            for b, t in zip(batch, table.placements)]
    e = local_map(lookup, out_placements=out,
                  in_placements=(table.placements, tokens.placements),
                  in_grad_placements=(grad, tokens.placements),
                  device_mesh=mesh)(table, tokens)
    return e.redistribute(mesh, batch)


# -- attention over a sequence ---------------------------------------------

def attn_split(mesh, hq: int, hkv: int, b: int) -> Optional[str]:
    """How `flash` splits the attention over the TP axis, with `b` batch
    rows on each rank: "heads" (each rank's query heads with their KV
    heads: hq divides by the axis, and the KV heads divide too or are
    repeated to its width), else "groups" (each rank's share of the
    (batch row, KV head) groups, a KV head with its query heads, when
    b * hkv divides by the axis), else None (every rank of the axis
    attends over all of them)."""
    ti = _tp_dim(mesh)
    if ti is None:
        return None
    tp = mesh.shape[ti]
    if hq % tp == 0 and (hkv % tp == 0 or tp % hkv == 0):
        return "heads"
    return "groups" if (b * hkv) % tp == 0 else None


def flash(q: DTensor, k: DTensor, v: DTensor, causal: bool,
          window: Optional[int], scale: Optional[float], use_kernel: bool,
          fwd=None) -> DTensor:
    """`flash_attention` on each rank's share of the attention: q (B, Hq,
    Sq, Dqk), k (B, Hkv, Skv, Dqk), v (B, Hkv, Skv, Dv) DTensors, the
    batch split as q's, and over the TP axis as `attn_split` says; o (B,
    Hq, Sq, Dv), its heads split over the axis ("heads") or whole on
    every rank of it."""
    mesh = q.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    place = _batch_of(q)
    ti = _tp_dim(mesh)
    from repro_torch.distributed.sharding import local_shape
    split = attn_split(mesh, hq, hkv,
                       local_shape(q.shape, mesh, place)[0][0])

    def core(q, k, v):
        return flash_attention(q, k, v, causal, window, scale, 0,
                               use_kernel, fwd)

    if split == "groups":
        return _group_flash(q, k, v, place, ti, core)
    if split == "heads":
        place[ti] = Shard(1)
        tp = mesh.shape[ti]
        if hkv % tp:  # each rank's query heads lie in one KV head
            k = k.repeat_interleave(tp // hkv, dim=1)
            v = v.repeat_interleave(tp // hkv, dim=1)
    q, k, v = (t.redistribute(mesh, place) for t in (q, k, v))
    return local_map(core, out_placements=place,
                     in_placements=(place, place, place),
                     device_mesh=mesh)(q, k, v)


def _group_flash(q: DTensor, k: DTensor, v: DTensor, place, ti: int,
                 core) -> DTensor:
    """`flash`'s "groups" split: the (batch row, KV head) groups on a
    leading axis, (B * Hkv, Hq / Hkv, S, D) for q and (B * Hkv, 1, S, D)
    for k and v (query head i reads KV head i // (Hq / Hkv)), split over
    the TP axis within each rank's batch; o gathered back over it."""
    mesh = q.device_mesh
    (b, hq, sq, _), hkv = q.shape, k.shape[1]
    q, k, v = (t.redistribute(mesh, place) for t in (q, k, v))
    q = q.reshape(b * hkv, hq // hkv, sq, q.shape[3])
    k, v = (t.reshape(b * hkv, 1, t.shape[2], t.shape[3]) for t in (k, v))
    grp = list(place)
    grp[ti] = Shard(0)
    q, k, v = (t.redistribute(mesh, grp) for t in (q, k, v))
    o = local_map(core, out_placements=grp, in_placements=(grp, grp, grp),
                  device_mesh=mesh)(q, k, v)
    return o.redistribute(mesh, place).reshape(b, hq, sq, o.shape[3])


# -- one new token against a sharded cache -----------------------------------

def decode_attend(q: DTensor, k: DTensor, v: DTensor, cache: dict,
                  cache_pos, window: Optional[int], scale: float) -> DTensor:
    """`layers.attention`'s decode over a DTensor cache ``{"k", "v"}``
    (B, Hkv, L, D), split over its batch and over its heads or its
    sequence (`sharding.cache_specs`): q (B, Hq, 1, D) and the new k, v
    (B, Hkv, 1, D) are written at slot ``cache_pos % L`` by the rank
    that holds it (in place), each rank attends over its own slots in
    float32, and the ranks' partial softmaxes (max, sum, weighted
    values) combine across the sequence's axis. Returns o (B, Hq, 1, D)
    in q's dtype, placed as q's heads."""
    kc, vc = cache["k"], cache["v"]
    mesh = kc.device_mesh
    ln = kc.shape[2]
    cpl = list(kc.placements)
    seq_split = [i for i, p in enumerate(cpl) if p == Shard(2)]
    rolling = window is not None and ln == window
    # the new token, and q, split as the cache but for its sequence: a
    # group of hq / hkv query heads follows each KV head
    new_pl = [Replicate() if p == Shard(2) else p for p in cpl]
    q, k, v = (t.redistribute(mesh, new_pl) for t in (q, k, v))
    if not is_dtensor(cache_pos):
        cache_pos = DTensor.from_local(cache_pos, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
    off = _offset(kc, 2)

    def local(q, kn, vn, kc, vc, pos):
        b, hql, _, dh = q.shape
        hkl, nl = kc.shape[1], kc.shape[2]
        slot = torch.remainder(pos, ln) - off
        own = (slot >= 0) & (slot < nl)
        at = slot.clamp(0, nl - 1).reshape(1).long()
        kc.index_copy_(2, at, torch.where(own, kn, kc.index_select(2, at)))
        vc.index_copy_(2, at, torch.where(own, vn, vc.index_select(2, at)))
        kpos = off + torch.arange(nl, device=kc.device)  # global slots
        if rolling:  # slot i holds position pos - ((pos - i) mod L)
            valid = pos - torch.remainder(pos - kpos, ln) >= 0
        else:
            valid = kpos < pos + 1
            if window is not None:
                valid &= kpos >= pos + 1 - window
        qf = q.float().reshape(b, hkl, hql // hkl, dh)
        sc = torch.einsum("bhgd,bhkd->bhgk", qf, kc.float()) * scale
        sc = torch.where(valid, sc, -1e30)
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        o = torch.einsum("bhgk,bhkd->bhgd", p, vc.float())
        return (o.reshape(1, b, hql, 1, vc.shape[-1]),
                m.reshape(1, b, hql, 1), p.sum(-1).reshape(1, b, hql, 1))

    # the partials' leading axis is the sequence's shards
    part = [Shard(0) if i in seq_split else
            Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
            for i, p in enumerate(new_pl)]
    o, m, s = local_map(
        local, out_placements=(part, part, part),
        in_placements=(new_pl, new_pl, new_pl, cpl, cpl,
                       [Replicate()] * mesh.ndim),
        device_mesh=mesh)(q, k, v, kc, vc, cache_pos)
    top = m.amax(0, keepdim=True)
    w = torch.exp(m - top)
    o = (o * w[..., None]).sum(0) / (s * w).sum(0)[..., None]
    return o.to(q.dtype)


# -- the loss over vocab-sharded logits --------------------------------------

def vocab_ce(logits: DTensor, targets, z_loss: float) -> DTensor:
    """`models.model._ce` on logits (B, S, V) whose vocab may be split
    over the TP axis: the log-sum-exp of each rank's columns (torch's
    own), combined across the axis; the target's logit from the rank
    whose columns hold it, summed over the axis. On one rank a step is
    bit for bit the plain `_ce`'s: the combination adds log(1) = 0."""
    mesh = logits.device_mesh
    ti = _tp_dim(mesh)
    want = _batch_of(logits)
    if ti is not None and logits.shape[-1] % mesh.shape[ti] == 0:
        want[ti] = Shard(2)
    logits = logits.float().redistribute(mesh, want)
    if not is_dtensor(targets):
        targets = DTensor.from_local(targets, mesh,
                                     [Replicate()] * mesh.ndim,
                                     run_check=False)
    off = _offset(logits, 2)
    cols = Shard(2)
    batch = _batch_of(logits)
    # (shards, B, S): the vocab's shards on a leading axis
    parts = [Shard(0) if p == cols else Shard(1) if b == Shard(0)
             else Replicate() for p, b in zip(logits.placements, batch)]
    lse_r = local_map(lambda lg: torch.logsumexp(lg, dim=-1)[None],
                      out_placements=parts,
                      in_placements=(logits.placements,),
                      device_mesh=mesh)(logits)
    top = lse_r.detach().amax(0, keepdim=True)
    lse = torch.log(torch.exp(lse_r - top).sum(0)) + top[0]

    def pick(lg, tg):
        idx = torch.clamp(tg.long(), min=0) - off
        ok = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(ok, got[..., 0], torch.zeros((), dtype=lg.dtype,
                                                        device=lg.device))

    out = [Partial() if p == cols else b
           for p, b in zip(logits.placements, batch)]
    picked = local_map(pick, out_placements=out,
                       in_placements=(logits.placements, targets.placements),
                       device_mesh=mesh)(logits, targets)
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (targets >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
