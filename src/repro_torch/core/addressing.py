"""d-bit address algebra for the binary tree routing protocol (paper §2).

The PyTorch counterpart of `repro.core.addressing`. A tree *position* is an
address of the form ``p 1 0^k`` (prefix ``p``, a set bit, ``k`` trailing
zeros); the root is the all-zero address:

    CW [p 1 0^k] = p 1 1 0^(k-1)        (clockwise descendant)
    CCW[p 1 0^k] = p 0 1 0^(k-1)        (counterclockwise descendant)
    UP [p 1 1 0^j] = p 1 0^(j+1)        (it is a CW child)
    UP [p 0 1 0^j] = p 1 0^(j+1)        (it is a CCW child)
    CW [0^d]      = 1 0^(d-1)           (root's single descendant)

Every function accepts either

  * torch ``int64`` tensors holding d-bit addresses (d <= 32). CPU torch
    has no uint32 arithmetic, so an address lives in the low 32 bits of an
    int64 and every result that can wrap is masked back to ``2^d - 1`` —
    the values are those of the reference's wrapping uint32 arithmetic;
  * numpy unsigned integers (uint64 for d <= 64, uint32 for d <= 32), the
    host path `Ring` uses.

Conventions match the reference: ``mask = 2^d - 1``; ``UP(0) = 0``; the
subtree of x spans ``(x - 2^k, x + 2^k - 1]`` with ``2^k = lowbit(x)``.
"""
from __future__ import annotations

import functools
from typing import Any, Tuple

import numpy as np
import torch

Array = Any  # torch.Tensor | np.ndarray | numpy scalar

UP, CW, CCW = 0, 1, 2  # direction codes


def _wrapok(fn):
    """Run under np.errstate(over='ignore'): modular wrap is intentional."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return inner


def _is_torch(a: Array) -> bool:
    return isinstance(a, torch.Tensor)


def _arr(a: Array) -> Array:
    return a if _is_torch(a) else np.asarray(a)


def _const(a: Array, v: int):
    """A constant usable against `a` (a Python int for torch, whose int64
    holds every 32-bit value; the array's own scalar type for numpy)."""
    if _is_torch(a):
        return v
    return np.asarray(a).dtype.type(v)


def _where(c, x, y, like: Array) -> Array:
    if _is_torch(like):
        return torch.where(c, x, y)
    return np.where(c, x, y).astype(np.asarray(like).dtype)


def mask_of(d: int) -> int:
    return (1 << d) - 1


def _masked(a: Array, d: int) -> Array:
    return a & _const(a, mask_of(d))


@_wrapok
def lowbit(a: Array) -> Array:
    """Lowest set bit of each address; 0 for the root address 0."""
    a = _arr(a)
    return a & (~a + _const(a, 1))


_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount(a: Array) -> Array:
    """Set-bit count. torch has no popcount: int64 SWAR form, exact for
    non-negative values (every d-bit address, d <= 32)."""
    if _is_torch(a):
        x = a - ((a >> 1) & _M1)
        x = (x & _M2) + ((x >> 2) & _M2)
        x = (x + (x >> 4)) & _M4
        x = x + (x >> 8)
        x = x + (x >> 16)
        x = x + (x >> 32)
        return x & 0x7F
    return np.bitwise_count(a).astype(np.asarray(a).dtype)


@_wrapok
def trailing_zeros(a: Array, d: int) -> Array:
    """Number of trailing zeros; returns d for the all-zero (root) address."""
    a = _arr(a)
    tz = popcount(lowbit(a) - _const(a, 1))
    return _where(a == 0, _const(a, d), tz, a)


@_wrapok
def highbit(a: Array, d: int) -> Array:
    """Highest set bit of each address; 0 if the address is 0."""
    a = _arr(a)
    x = a
    shift = 1
    # torch int64 holds 32-bit values: the uint32 reference's 5 folds
    nbits = 32 if _is_torch(a) or np.dtype(a.dtype).itemsize < 8 else 64
    while shift < nbits:
        x = x | (x >> _const(a, shift))
        shift <<= 1
    return _masked(x - (x >> _const(a, 1)), d)


def depth(pos: Array, d: int) -> Array:
    """Tree depth of a position: 0 for the root, else d - trailing_zeros."""
    return _const(pos, d) - trailing_zeros(pos, d)


@_wrapok
def up(pos: Array, d: int) -> Array:
    """Parent position. UP(root)=root."""
    pos = _arr(pos)
    m = lowbit(pos)
    m2 = _masked(m << _const(pos, 1), d)  # bit above the lowbit
    is_cw_child = (pos & m2) != 0
    up_cw = pos ^ m
    up_ccw = _masked((pos ^ m) | m2, d)  # MSB case -> 0 (root)
    out = _where(is_cw_child, up_cw, up_ccw, pos)
    return _where(pos == 0, pos, out, pos)


@_wrapok
def cw(pos: Array, d: int) -> Array:
    """Clockwise descendant. CW(root) = 10^(d-1); a leaf returns itself."""
    pos = _arr(pos)
    child = pos | (lowbit(pos) >> _const(pos, 1))
    return _where(pos == 0, _const(pos, 1 << (d - 1)), child, pos)


@_wrapok
def ccw(pos: Array, d: int) -> Array:
    """Counterclockwise descendant; undefined for root (returns 0)."""
    pos = _arr(pos)
    m = lowbit(pos)
    child = (pos ^ m) | (m >> _const(pos, 1))
    return _where(pos == 0, pos, child, pos)


def is_leaf(pos: Array) -> Array:
    """Addresses ending with a set bit (k = 0) have no descendants."""
    return (pos & _const(pos, 1)) != 0


def span(pos: Array) -> Array:
    """Half-width of the subtree address range: lowbit(pos); 0 for root."""
    return lowbit(pos)


@_wrapok
def in_subtree(x: Array, y: Array, d: int) -> Array:
    """Is address y inside the subtree rooted at position x (inclusive)?"""
    x, y = _arr(x), _arr(y)
    s = lowbit(x)
    one = _const(x, 1)
    size = _masked((s << one) - one, d)  # 2s - 1 addresses
    rel = _masked(y - (x - s) - one, d)
    inside = rel < size
    if _is_torch(x):
        return torch.where(x == 0, torch.ones_like(inside), inside)
    return np.where(np.asarray(x) == 0, True, inside)


def is_foreparent(x: Array, y: Array, d: int) -> Array:
    """Is position x a strict ancestor of address y?"""
    return in_subtree(x, y, d) & (x != y)


@_wrapok
def in_cw_subtree(x: Array, y: Array, d: int) -> Array:
    """Is y inside the clockwise subtree of x?  range (x, x + s - 1]."""
    x, y = _arr(x), _arr(y)
    s = lowbit(x)
    one = _const(x, 1)
    rel = _masked(y - x - one, d)
    inside = rel < (s - one)
    root_case = y != 0  # CW subtree of the root is every non-zero address
    if _is_torch(x):
        return torch.where(x == 0, root_case, inside)
    return np.where(np.asarray(x) == 0, root_case, inside)


@_wrapok
def in_ccw_subtree(x: Array, y: Array, d: int) -> Array:
    """Is y inside the counterclockwise subtree of x?  range (x - s, x - 1]."""
    x, y = _arr(x), _arr(y)
    s = lowbit(x)
    one = _const(x, 1)
    rel = _masked(y - (x - s) - one, d)
    inside = rel < (s - one)
    if _is_torch(x):
        return torch.where(x == 0, torch.zeros_like(inside), inside)
    return np.where(np.asarray(x) == 0, False, inside)


@_wrapok
def position_from_segment(prev: Array, self_addr: Array, d: int) -> Array:
    """Tree position of the peer owning segment (prev, self]; the wrapped
    segment (prev >= self) takes the root position 0."""
    prev, self_addr = _arr(prev), _arr(self_addr)
    h = highbit(prev ^ self_addr, d)  # the first differing bit
    pos = self_addr & ~(h - _const(h, 1))
    return _where(prev >= self_addr, _const(pos, 0), pos, pos)


def ring_positions(addrs_sorted: Array, d: int) -> Array:
    """Positions of all peers given the sorted ring of peer addresses."""
    if _is_torch(addrs_sorted):
        prev = torch.roll(addrs_sorted, 1)
    else:
        prev = np.roll(addrs_sorted, 1)
    return position_from_segment(prev, addrs_sorted, d)


def direction_of(origin_pos: Array, self_pos: Array, d: int) -> Array:
    """Direction (0=UP, 1=CW, 2=CCW) of `origin_pos` seen from `self_pos`."""
    from_up = is_foreparent(origin_pos, self_pos, d)
    from_cw = in_cw_subtree(self_pos, origin_pos, d)
    if _is_torch(self_pos):
        return torch.where(from_up, 0, torch.where(from_cw, 1, 2))
    return np.where(from_up, 0, np.where(from_cw, 1, 2))


def descendant(pos: Array, direction: int, d: int) -> Array:
    """The CW or CCW descendant of `pos` (`direction` is CW or CCW)."""
    return cw(pos, d) if direction == CW else ccw(pos, d)


def random_ring(n: int, d: int, seed: int, dtype=np.uint64) -> np.ndarray:
    """n distinct random d-bit peer addresses, sorted ascending (numpy)."""
    if n > mask_of(d):
        raise ValueError(f"cannot place {n} peers in a {d}-bit space")
    rng = np.random.default_rng(seed)
    out = np.empty(0, dtype=dtype)
    need = n
    while need > 0:
        cand = rng.integers(0, mask_of(d), size=2 * need + 16, dtype=np.uint64)
        cand = (cand & np.uint64(mask_of(d))).astype(dtype)
        out = np.unique(np.concatenate([out, cand]))
        need = n - out.size
    if out.size > n:
        out = rng.choice(out, size=n, replace=False)
        out.sort()
    return out


def tree_neighbors_reference(addrs_sorted: np.ndarray, d: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ground-truth (UP, CW, CCW) peer indices for every peer, from Lemma 2.

    For peer i: the CW neighbor is the unique peer whose position is the
    fore-parent of all occupied positions in the subtree of CW[pos_i]
    (= minimum depth among them); symmetrically CCW. The UP neighbor is the
    owner-peer of the first ancestor address (walking UP from pos_i) that is
    some peer's position. Returns -1 where the neighbor does not exist.
    O(N log N); numpy only — the control tree of `runtime.elastic.Membership`.
    """
    n = addrs_sorted.size
    pos = ring_positions(addrs_sorted, d)
    pos_to_peer = {int(p): i for i, p in enumerate(pos)}
    dep = depth(pos, d).astype(np.int64)

    up_n = np.full(n, -1, dtype=np.int64)
    cw_n = np.full(n, -1, dtype=np.int64)
    ccw_n = np.full(n, -1, dtype=np.int64)

    # UP: walk ancestors until an occupied position.
    for i in range(n):
        p = int(pos[i])
        if p == 0:
            continue  # root
        cur = p
        while True:
            cur = int(up(np.asarray(cur, dtype=addrs_sorted.dtype), d))
            if cur in pos_to_peer:
                up_n[i] = pos_to_peer[cur]
                break
            if cur == 0:
                break  # 0 not occupied as a *position* only if no wrap peer; cannot happen
    # CW/CCW: the min-depth occupied position in each child subtree. Sort
    # peers by position; child subtrees are contiguous position ranges.
    order = np.argsort(pos, kind="stable")
    pos_sorted = pos[order]
    for i in range(n):
        p = pos[i]
        if int(p) == 0:
            # Root: CW subtree is every other peer.
            if n > 1:
                rest = np.arange(n) != i
                j = np.argmin(np.where(rest, dep, np.iinfo(np.int64).max))
                cw_n[i] = j
            continue
        s = int(lowbit(p))
        if s == 1:
            continue  # leaf address: no descendants
        # CW range (p, p + s - 1]; CCW range (p - s, p - 1] — contiguous, no wrap
        for (lo, hi, out) in (
            (int(p) + 1, int(p) + s - 1, cw_n),
            (int(p) - s + 1, int(p) - 1, ccw_n),
        ):
            a = np.searchsorted(pos_sorted, np.asarray(lo, dtype=pos.dtype), side="left")
            b = np.searchsorted(pos_sorted, np.asarray(hi, dtype=pos.dtype), side="right")
            if b > a:
                cand = order[a:b]
                out[i] = cand[np.argmin(dep[cand])]
    return up_n, cw_n, ccw_n
