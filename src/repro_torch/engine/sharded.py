"""Sharded engine on `torch.distributed`: the peer planes and the delivery
wheel partitioned over the ranks of a process group, one process a rank.

The counterpart of `repro.engine.sharded.ShardedJaxEngine`, whose one
``shard_map`` program over a device mesh becomes W processes here, each
running the same `TorchEngine` code on its own blocks (SPMD: every rank
makes the same calls in the same order). Rank r of W holds:

  * peer rows ``[r pad / W, (r + 1) pad / W)`` of the partitioned planes
    `x`, `inbox`, `out`, `heard` and `probed`;
  * the matching owner lanes ``[r L / W, (r + 1) L / W)`` of the wheel and
    the ALERT side-wheel, with their per-lane counters (`wcnt`, `acnt`,
    `messages_sent`, `dropped`, `deferred`, `enq`, `ret`, `lost`);
  * replicated copies of the ring tables and scalars (`addrs`, `prev`,
    `pos`, `n_live`, `dead`, `perms`, `salt_enq`, `evt_ctr`, `t`),

the partition of the reference's `_state_specs`. A wheel row lives in the
lane of its DEST owner, and a lane lives with its peer block, so the
drain path (due scan, routing, the accept election, the react, the
wheel's slip and shift) touches only local rows: `ShardedPlane` turns the
engine's global row and link indices into local ones. What crosses
ranks each cycle is one boundary exchange — an all_gather of every rank's
staged lane blocks, in 32-bit columns with the live and ALERT flags in a
meta column, into the global lane-major order from which each rank
appends the rows its lanes own — and one scalar all-reduce for the
convergence check (an armed engine adds one scalar max, its alert
window). The event paths (`set_votes`, the init storm, join/leave, the
fault sweep) gather what they need explicitly. Every exchanged value is
an exact integer and the append ranks run over the same global order as
on one device, so the trajectory is bit-identical to `TorchEngine` at
every world size.

    import torch.distributed as dist
    from repro_torch.engine import make_engine
    dist.init_process_group("nccl")            # e.g. under torchrun
    eng = make_engine("torch", ring, votes, seed=0, mesh=True)
    res = eng.run_until_converged(truth=1)     # on every rank

`launch.mesh.spawn` starts W ranks in one call (the tests, `chip_smoke`).
The collective backend is the caller's group's; the engine never picks
or changes it.

`resize_mesh(k)` re-partitions the live engine onto the first k ranks of
the group it was built on (the reference's `resize_mesh`, whose mesh
becomes a `dist.new_group` of those ranks): every rank of that group
calls it, the state is gathered and re-cut, and the trajectory goes on
bit for bit. A rank outside the k holds no lanes and takes no other
call until a later resize brings it back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.engine.torch_backend import (I32, M32, NDIR, DeviceState,
                                             PeerPlane, TorchEngine, _i32)

# DeviceState fields held in blocks along their first axis (peer rows,
# links peer * 3 + dir, or owner lanes); every other field is replicated
PARTITIONED = ("x", "out", "inbox", "heard", "probed", "wheel", "wcnt",
               "awheel", "acnt", "messages_sent", "dropped", "deferred",
               "enq", "ret", "lost")

META_LIVE, META_ALERT = 1, 2  # the exchange's meta column


def as_engine_group(mesh):
    """The `mesh=` argument as a process group: a `ProcessGroup` passes
    through; True means the default group; an int must equal the default
    group's size (`launch.mesh.make_engine_group` builds a group of the
    first k ranks)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh= needs an initialized torch.distributed process group "
            "(launch.mesh.init_from_env under torchrun, or launch.mesh.spawn)")
    if mesh is True:
        return dist.group.WORLD
    if isinstance(mesh, bool) or mesh is None:
        raise ValueError(f"mesh={mesh!r}: want a ProcessGroup, True or an int")
    if isinstance(mesh, int):
        if mesh != dist.get_world_size():
            raise ValueError(
                f"mesh={mesh} differs from the default group's size "
                f"{dist.get_world_size()}; pass launch.mesh."
                f"make_engine_group({mesh})")
        return dist.group.WORLD
    return mesh


# the most device memory one slice of a host gather (`_gather_host`) may
# take, its gathered copy included
GATHER_BYTES = 1 << 26


def _gather_list(t: torch.Tensor, group) -> list:
    """All_gather of equal blocks: every rank's block, by rank (bool
    travels as uint8)."""
    flag = t.dtype == torch.bool
    src = (t.view(torch.uint8) if flag else t).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.view(torch.bool) for o in out] if flag else out


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """All_gather of equal blocks along dim 0, on the block's device."""
    return torch.cat(_gather_list(t, group))


def _gather_host(t: torch.Tensor, group) -> torch.Tensor:
    """All_gather of equal blocks along dim 0 into host memory, slice by
    slice along dim 0 (the same slices on every rank): each slice's
    gathered copy takes at most `GATHER_BYTES` of the device and goes to
    the host before the next, so the whole array (the wheel, the armed
    side-wheel) is never on one rank's device."""
    W, n = dist.get_world_size(group), t.shape[0]
    row = t.element_size() * (t.numel() // max(n, 1))
    step = max(1, GATHER_BYTES // max(row * W, 1))
    parts = [[] for _ in range(W)]
    for lo in range(0, n, step):
        for r, g in enumerate(_gather_list(t[lo: lo + step], group)):
            parts[r].append(g.cpu())
    return torch.cat([torch.cat(p) for p in parts])


class ShardedPlane(PeerPlane):
    """The owner-partitioned `PeerPlane` of one rank (module docstring):
    gathers and scatters translate global indices into the local block
    (an index outside it reads 0 and writes nowhere; by the ownership
    invariant the drain path never reaches one with a live row), and the
    global contracts — `exchange`, `gather_events`, `shift_rows`,
    `take_peer_rep`, the reductions and `full` — are collectives."""

    def __init__(self, eng: "ShardedTorchEngine"):
        super().__init__(eng)
        self.group = eng.group
        self.rank = eng.rank

    @property
    def lane_base(self) -> int:
        return self.rank * self.eng.loc_lanes

    @property
    def row_base(self) -> int:
        return self.rank * self.eng.loc_rows

    def _loc(self, nloc: int, idx: torch.Tensor):
        """Global row index -> (local index, clamped to 0 outside the
        block; ownership mask)."""
        loc = idx - self.rank * nloc
        ok = (loc >= 0) & (loc < nloc)
        return torch.where(ok, loc, 0), ok

    def _take(self, arr, idx):
        loc, ok = self._loc(arr.shape[0], idx)
        v = arr[loc]
        return torch.where(ok.reshape(ok.shape + (1,) * (v.dim() - ok.dim())),
                           v, 0)

    take_peer = take_link = _take

    def take_peer_rep(self, arr, idx):
        v = self._take(arr, idx)
        dist.all_reduce(v, group=self.group)  # one owner: the sum is its row
        return v

    def put_peer(self, name, idx, val):
        store = self.eng._store[name]
        nloc = store.shape[0] - 1  # the last row is the drop sentinel
        loc = idx - self.rank * nloc
        ok = (loc >= 0) & (loc < nloc)
        store.index_put_((torch.where(ok, loc, nloc),), torch.as_tensor(
            val, dtype=store.dtype, device=store.device))

    put_link = put_peer

    def link_ids(self, flat):
        nl = self.eng.loc_rows * NDIR
        return self._loc(nl, flat)[0], nl

    def local(self, arr):
        return arr[self.row_base: self.row_base + self.eng.loc_rows]

    def occ(self):
        e = self.eng
        return torch.arange(self.row_base, self.row_base + e.loc_rows,
                            device=e.device) < e.n

    def all_true(self, ok):
        miss = (~ok).any().to(I32).reshape(1)
        dist.all_reduce(miss, group=self.group)
        return miss == 0

    def all_max(self, v):
        m = v.max().to(torch.int64).reshape(1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return int(m)

    def total(self, v):
        s = v.sum(dtype=torch.int64).reshape(1)
        dist.all_reduce(s, group=self.group)
        return int(s)

    def full(self, arr):
        return _gather(arr, self.group)

    def exchange(self, *blocks):
        """One all_gather for all `blocks`: each rank packs its blocks
        side by side into one int32 (L_loc, sum R, C + 1) packet — the
        rows' 32-bit values and a meta column of live / ALERT flags —
        and unpacks the gathered (L, sum R, C + 1) packet."""
        cols = []
        for rows, live, alert in blocks:
            meta = live.to(I32) * META_LIVE
            if alert is not None:
                meta = meta | alert.to(I32) * META_ALERT
            cols.append(torch.cat([_i32(rows), meta[..., None]], dim=-1))
        got = _gather(torch.cat(cols, dim=1) if len(cols) > 1 else cols[0],
                      self.group)
        out, at = [], 0
        for rows, _, alert in blocks:
            r = rows.shape[1]
            part = got[:, at: at + r]
            at += r
            meta = part[..., -1]
            out.append((part[..., :-1].to(torch.int64) & M32,
                        (meta & META_LIVE) != 0,
                        None if alert is None else (meta & META_ALERT) != 0))
        return out

    def shift_rows(self, arr, src):
        nloc = arr.shape[0]
        lo = self.rank * nloc
        return _gather(arr, self.group)[src[lo: lo + nloc]]

    def gather_events(self, *arrs):
        return tuple(_gather(a, self.group) for a in arrs)


class ShardedTorchEngine(TorchEngine):
    """`TorchEngine` over the ranks of a process group (module
    docstring): same API, same trajectory, bit for bit. Every rank
    constructs it with the same arguments and drives it through the same
    calls; the host readers (`outputs`, `votes`, `data`, the counters,
    `check_conservation`, `last_heard`) return the whole ring's values on
    every rank."""

    sharded = True

    def __init__(self, ring, votes, seed: int = 0, mesh=True, **kwargs):
        if kwargs.get("_trials") is not None:
            raise NotImplementedError("no trial axis on a sharded engine")
        self.group = as_engine_group(mesh)
        self.n_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if self.rank < 0:
            raise ValueError("this process is not a member of the group")
        if self.n_shards & (self.n_shards - 1):
            raise ValueError(f"engine group size must be a power of two, "
                             f"got {self.n_shards}")
        # the group the engine was built on, which `resize_mesh` cuts
        # subgroups of its first k ranks from (cached by k)
        self._home, self._groups = self.group, {self.n_shards: self.group}
        super().__init__(ring, votes, seed=seed, **kwargs)

    @classmethod
    def from_state(cls, ring, state, seed: int = 0, mesh=True,
                   **sizing) -> "ShardedTorchEngine":
        """Resume from a GLOBAL state (a `DeviceState`, or numpy arrays in
        the reference's layout, see `engine.convert`); each rank keeps
        its blocks. `sizing` must match the engine that produced it."""
        from repro_torch.engine.convert import state_from_numpy

        if isinstance(state, dict):
            state = state_from_numpy(state)
        return cls(ring, None, seed=seed, mesh=mesh, _state=state, **sizing)

    def _size_tables(self):
        super()._size_tables()
        if self.lanes % self.n_shards:
            raise ValueError(
                f"{self.n_shards} ranks do not divide the {self.lanes} wheel "
                f"lanes (pad={self.pad})")

    def _make_plane(self) -> ShardedPlane:
        return ShardedPlane(self)

    def _one_trial(self, what: str) -> None:
        if self.group is None:
            raise RuntimeError(
                f"ShardedTorchEngine.{what}: this rank holds no lanes since "
                f"resize_mesh({self.n_shards}); only the first "
                f"{self.n_shards} ranks of the engine's group take its calls "
                f"until a resize brings this one back")
        super()._one_trial(what)

    @property
    def active(self) -> bool:
        """Whether this rank holds lanes (False after a `resize_mesh`
        that left it out)."""
        return self.group is not None

    def resize_mesh(self, k) -> None:
        """Re-partition the LIVE engine onto the first `k` ranks (a power
        of two; True: all) of the group it was built on. Every rank of
        that group calls it. The lane layout does not depend on the rank
        count, so this is data movement: the ranks holding lanes gather
        the whole state to their hosts, rank 0 hands it (with the ring
        and the detector's host tables) to any rank that comes back, and
        each of the k keeps its blocks. The trajectory continues
        bit-identically; a rank past k drops its blocks."""
        from repro_torch.engine.convert import state_from_numpy

        home = self._home
        world = dist.get_world_size(home)
        k = world if k is True else int(k)
        if not 1 <= k <= world or k & (k - 1):
            raise ValueError(f"resize_mesh({k}): want a power of two in "
                             f"1..{world}, the ranks of the engine's group")
        old, me = self.n_shards, dist.get_rank(home)
        if k == old:
            return
        host = self.global_state() if self.active else None
        self.n_shards = k
        if me >= k:
            self.group, self._st, self._store = None, None, None
            self._plane = None
            return
        if k not in self._groups:  # only the k members take part
            self._groups[k] = dist.new_group(
                [dist.get_global_rank(home, i) for i in range(k)],
                use_local_synchronization=True)
        self.group, self.rank = self._groups[k], me
        if k > old:  # ranks old..k-1 come back with rank 0's copy
            box = [(self.ring, self.pad, self._evictions, self._heard_floor,
                    self._evict_floor, host) if me == 0 else None]
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(home, 0), group=self.group)
            if me >= old:
                (self.ring, self.pad, self._evictions, self._heard_floor,
                 self._evict_floor, host) = box[0]
                self.n = int(self.ring.n)
        self._size_tables()
        self._plane = self._make_plane()
        self._adopt(state_from_numpy(host))

    def _adopt(self, st: DeviceState) -> None:
        """Take this rank's blocks of the GLOBAL state `st`."""
        super()._adopt(self._local_state(st))

    def _local_state(self, st: DeviceState) -> DeviceState:
        """This rank's view of a global state: the partitioned fields
        sliced to its blocks (a None arena stays None), the rest as is."""
        W, r = self.n_shards, self.rank

        def cut(k, v):
            if v is None or k not in PARTITIONED:
                return v
            n = v.shape[0] // W
            return v[r * n: (r + 1) * n]

        return DeviceState(**{k: cut(k, v) for k, v in st._asdict().items()})

    def global_state(self) -> Dict[str, np.ndarray]:
        """The whole state on the host in the reference's layout and dtypes
        (`convert.state_to_numpy`), on every rank: the partitioned fields
        gathered from every rank straight to the host (`_gather_host`),
        the replicated ones copied."""
        from repro_torch.engine.convert import state_to_numpy

        self._one_trial("global_state")
        return state_to_numpy(DeviceState(**{
            k: (_gather_host(v, self.group) if k in PARTITIONED else v.cpu())
            for k, v in self._st._asdict().items()}))
