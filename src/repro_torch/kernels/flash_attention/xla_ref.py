"""Plain FlashAttention-2 pair schedule: the reference's
`repro.kernels.flash_attention.xla_ref._pair_fwd` / `_pair_bwd` in
PyTorch.

The (q block, kv block) pairs with any visible entry are computed in
turn, each with an online-softmax update (forward) or the FA2 backward
recomputed from the saved log-sum-exp. `pair_fwd` is the plain version
of the CUDA kernel `flash_attention_fwd`; `pair_bwd` is the backward of
the port's `flash_attention` on every device (the reference, too,
computes its backward outside any Pallas kernel). Its products are
`torch.matmul` in float32.

Two generalisations. The visible pairs here account for `q_offset`. The
reference's `_visible_pairs` ignores it, which is the same at
q_offset = 0 (the only value its models pass) and would drop visible
blocks above it; the kernels' skip rule does account for it. And ragged
lengths (1,500 audio frames, 4,100 vision tokens) are padded to a block
of a useful size, the padded keys masked (the reference's `kv_len`) and
the padded rows dropped, where the reference's block rule would fall to
blocks of 4 keys and a pair loop of 1e5 steps (`blocking`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

F32 = torch.float32
NEG = -1e30


def _block_mask(qpos, kpos, causal: bool, window: Optional[int],
                kv_len: Optional[int] = None):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        m &= kpos[None, :] < kv_len
    return m


def pick_block(sq: int, skv: int, want: int = 512) -> int:
    c = min(want, sq, skv)
    while sq % c or skv % c:
        c //= 2
    return max(c, 1)


def blocking(sq: int, skv: int, want: int = 512) -> Tuple[int, int, int]:
    """(block c, Sq and Skv padded to multiples of c). Lengths with a
    common block of at least min(64, Sq, Skv) keep the reference's block
    and are not padded; ragged ones take the largest power of two up to
    `want` that the shorter length reaches, and are padded."""
    c = pick_block(sq, skv, want)
    if c >= min(64, sq, skv):
        return c, sq, skv
    c = min(want, 1 << (min(sq, skv).bit_length() - 1))
    return c, -(-sq // c) * c, -(-skv // c) * c


def _pad(t: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """`t` padded along its third axis (the sequence) to length n."""
    if t.shape[2] == n:
        return t
    tail = (0, 0) * (t.dim() - 3) + (0, n - t.shape[2])
    return torch.nn.functional.pad(t, tail, value=value)


def visible_pairs(nq: int, nk: int, c: int, causal: bool,
                  window: Optional[int], q_offset: int = 0
                  ) -> List[Tuple[int, int]]:
    """(q block, kv block) pairs with any unmasked entry, in the
    reference's order (q block major)."""
    pairs = []
    for qi in range(nq):
        lo_pos, hi_pos = q_offset + qi * c, q_offset + qi * c + c - 1
        hi = min(hi_pos // c, nk - 1) if causal else nk - 1
        lo = max(0, (lo_pos - window + 1) // c) if window is not None else 0
        pairs.extend((qi, ki) for ki in range(lo, hi + 1))
    return pairs


def _blocks(b, hkv, g, nq, c, t: torch.Tensor) -> torch.Tensor:
    """(b, hq, sq, d) -> (nq, b, hkv, g * c, d) in float32: the rows of a
    q block are (head in group, position in block)."""
    d = t.shape[-1]
    return (t.reshape(b, hkv, g, nq, c, d).permute(3, 0, 1, 2, 4, 5)
            .reshape(nq, b, hkv, g * c, d).to(F32))


def _kv_blocks(b, hkv, nk, c, t: torch.Tensor) -> torch.Tensor:
    d = t.shape[-1]
    return t.reshape(b, hkv, nk, c, d).permute(2, 0, 1, 3, 4).to(F32)


def _unblock(b, hkv, g, nq, c, t: torch.Tensor) -> torch.Tensor:
    """Inverse of `_blocks` for (nq, b, hkv, g * c, ...) tensors."""
    tail = t.shape[4:]
    return (t.reshape(nq, b, hkv, g, c, *tail)
            .permute(1, 2, 3, 0, 4, *range(5, 5 + len(tail)))
            .reshape(b, hkv * g, nq * c, *tail))


def pair_fwd(q, k, v, causal: bool, window: Optional[int],
             scale: Optional[float], q_offset: int = 0):
    """(o in q's dtype (B, Hq, Sq, Dv), lse float32 (B, Hq, Sq))."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    g = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    c, sqp, skvp = blocking(sq, skv)
    kv_len = skv if skvp != skv else None
    nq, nk = sqp // c, skvp // c
    dev = q.device
    qb = _blocks(b, hkv, g, nq, c, _pad(q, sqp)) * scale
    kb = _kv_blocks(b, hkv, nk, c, _pad(k, skvp))
    vb = _kv_blocks(b, hkv, nk, c, _pad(v, skvp))
    rel = torch.arange(c, device=dev).repeat(g)  # row -> position in block
    acc = [torch.zeros((b, hkv, g * c, dhv), dtype=F32, device=dev)
           for _ in range(nq)]
    m = [torch.full((b, hkv, g * c), NEG, dtype=F32, device=dev)
         for _ in range(nq)]
    l = [torch.zeros((b, hkv, g * c), dtype=F32, device=dev)
         for _ in range(nq)]
    for qi, ki in visible_pairs(nq, nk, c, causal, window, q_offset):
        s = torch.matmul(qb[qi], kb[ki].transpose(-1, -2))
        mask = _block_mask(q_offset + qi * c + rel,
                           ki * c + torch.arange(c, device=dev), causal,
                           window, kv_len)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m[qi], s.amax(-1))
        alpha = torch.exp(m[qi] - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l[qi] = l[qi] * alpha + p.sum(-1)
        acc[qi] = acc[qi] * alpha[..., None] + torch.matmul(p, vb[ki])
        m[qi] = m_new
    l_all = torch.clamp(torch.stack(l), min=1e-30)
    o = torch.stack(acc) / l_all[..., None]
    lse = torch.stack(m) + torch.log(l_all)
    return (_unblock(b, hkv, g, nq, c, o)[:, :, :sq].to(q.dtype),
            _unblock(b, hkv, g, nq, c, lse)[:, :, :sq])


def pair_bwd(q, k, v, o, lse, gout, causal: bool, window: Optional[int],
             scale: Optional[float], q_offset: int = 0):
    """(dq, dk, dv) in float32 from the saved (q, k, v, o, lse) and the
    output cotangent `gout`."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    g = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    c, sqp, skvp = blocking(sq, skv)
    kv_len = skv if skvp != skv else None
    nq, nk = sqp // c, skvp // c
    dev = q.device
    qb = _blocks(b, hkv, g, nq, c, _pad(q, sqp))
    gb = _blocks(b, hkv, g, nq, c, _pad(gout, sqp))
    drow = (gb * _blocks(b, hkv, g, nq, c, _pad(o, sqp))).sum(-1)
    # padded rows: an lse of 1e30 makes their probabilities 0
    lseb = _blocks(b, hkv, g, nq, c, _pad(lse, sqp, -NEG)[..., None])[..., 0]
    kb = _kv_blocks(b, hkv, nk, c, _pad(k, skvp))
    vb = _kv_blocks(b, hkv, nk, c, _pad(v, skvp))
    rel = torch.arange(c, device=dev).repeat(g)
    dq = torch.zeros((nq, b, hkv, g * c, dh), dtype=F32, device=dev)
    dk = torch.zeros((nk, b, hkv, c, dh), dtype=F32, device=dev)
    dv = torch.zeros((nk, b, hkv, c, dhv), dtype=F32, device=dev)
    for qi, ki in visible_pairs(nq, nk, c, causal, window, q_offset):
        qq, kk, vv, gg = qb[qi], kb[ki], vb[ki], gb[qi]
        s = torch.matmul(qq, kk.transpose(-1, -2)) * scale
        mask = _block_mask(q_offset + qi * c + rel,
                           ki * c + torch.arange(c, device=dev), causal,
                           window, kv_len)
        p = torch.where(mask, torch.exp(s - lseb[qi][..., None]), 0.0)
        dv[ki] += torch.matmul(p.transpose(-1, -2), gg)
        dp = torch.matmul(gg, vv.transpose(-1, -2))
        ds = p * (dp - drow[qi][..., None]) * scale
        dq[qi] += torch.matmul(ds, kk)
        dk[ki] += torch.matmul(ds.transpose(-1, -2), qq)
    dq = _unblock(b, hkv, g, nq, c, dq)[:, :, :sq]
    dk = dk.permute(1, 2, 0, 3, 4).reshape(b, hkv, skvp, dh)[:, :, :skv]
    dv = dv.permute(1, 2, 0, 3, 4).reshape(b, hkv, skvp, dhv)[:, :, :skv]
    return dq, dk, dv
