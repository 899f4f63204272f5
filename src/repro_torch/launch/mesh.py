"""Process groups for the sharded engine (`engine.sharded`) and the
expert-parallel MoE (`distributed.moe_ep`).

The counterpart of `repro.launch.mesh.make_engine_mesh`: where the
reference builds a one-axis device mesh for one program, the port runs
one process a rank. Three ways in:

  * under ``torchrun``: `init_from_env()` in every process, then
    ``make_engine(..., mesh=make_engine_group(k))``;
  * from one Python process: ``spawn(fn, world, backend, device, *args)``
    starts `world` ranks, runs ``fn(rank, world, device, *args)`` in each
    and returns every rank's result (the tests and ``chip_smoke.py``);
  * a group the caller already has: ``make_engine(..., mesh=group)``.

The sharding plan's meshes (`distributed.sharding`) are DTensor
`DeviceMesh`es: `make_production_mesh` (16 x 16, or 2 x 16 x 16) and
`make_mesh`. A mesh of named axes as process groups (the reference's
``jax.make_mesh`` for one program) is `make_process_mesh`: ``make_process_mesh((2, 2),
("data", "model"))`` on every rank of a 4-rank group gives each rank its
coordinates and the groups of its row and column.

The collective backend is always the caller's choice; nothing here picks
one or falls back to another.

    python -m torch.distributed.run --nproc-per-node 4 my_sim.py
    # my_sim.py
    from repro_torch.launch.mesh import init_from_env, make_engine_group
    init_from_env("nccl")
    eng = make_engine("torch", ring, votes, mesh=make_engine_group())
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def make_mesh(dp: int, tp: int, pods: int = 1):
    """A `DeviceMesh` over every rank of the default group: (data, model)
    = (dp, tp), or (pod, data, model) = (pods, dp, tp) with pods > 1 (the
    reference's `make_mesh`; ranks laid out row-major, the last axis
    fastest). On the group initialised already: NCCL's ranks on CUDA,
    any other backend's (gloo, the dry run's fake group) on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = ((pods, dp, tp), ("pod", "data", "model")) if pods > 1 \
        else ((dp, tp), ("data", "model"))
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False):
    """The reference's production meshes: 16 x 16 = 256 ranks (data,
    model); with `multi_pod`, two of them, (pod, data, model) = (2, 16,
    16) = 512 ranks. Needs a default group of that many ranks (the dry
    run's fake one)."""
    return make_mesh(16, 16, 2 if multi_pod else 1)


def make_engine_group(n_shards: int = 0):
    """The group of the first `n_shards` ranks of the default group (all
    of them when 0). Power-of-two sizes only: the engine's padded tables
    split into power-of-two row blocks and its owner lanes (at most 8)
    must divide evenly (`lanes % n_shards == 0`). With fewer ranks than
    the world, every rank must call this (`dist.new_group`); a rank
    outside the group gets a handle it cannot build an engine on."""
    world = dist.get_world_size()
    k = int(n_shards) or world
    if not 1 <= k <= world:
        raise ValueError(f"need 1..{world} ranks, got {k}")
    if k & (k - 1):
        raise ValueError(f"engine group size must be a power of two, got {k}")
    if k == world:
        return dist.group.WORLD
    return dist.new_group(list(range(k)))


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A device mesh as process groups (`make_process_mesh`): the axes'
    names and sizes, this rank's coordinate along each, and along each
    the group of the ranks that differ from this one on that axis only."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Any, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def make_process_mesh(shape, axis_names=("data", "model"), ranks=None):
    """`ranks` (default: every rank of the default group, in order) laid
    out row-major on a mesh of `shape` (the last axis fastest: the i-th
    rank at d * model + m on ("data", "model"), as ``jax.make_mesh``
    lays out devices in order). Every rank of the default group must
    call this alike: it makes every axis line's group (`dist.new_group`).
    A rank outside `ranks` gets None."""
    shape = tuple(int(n) for n in shape)
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else [int(r) for r in ranks]
    if len(shape) != len(axis_names) or math.prod(shape) != len(ranks):
        raise ValueError(f"mesh {shape} over {tuple(axis_names)} does not "
                         f"lay out {len(ranks)} ranks")
    rank = dist.get_rank()
    grid = torch.tensor(ranks).view(shape)
    groups = []
    for a, n in enumerate(shape):
        mine = None
        for line in grid.movedim(a, -1).reshape(-1, n).tolist():
            g = dist.new_group(line)
            if rank in line:
                mine = g
        groups.append(mine)
    if rank not in ranks:
        return None
    coords = tuple(int(i) for i in torch.nonzero(grid == rank)[0])
    return ProcessMesh(tuple(axis_names), shape, coords, tuple(groups))


def init_from_env(backend: str = "nccl", device=None) -> torch.device:
    """Initialize the default group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) on `backend`, and
    return this rank's device: `device` if given, else
    ``cuda:<LOCAL_RANK>`` (set as the current device; raises without
    CUDA, as every entry point of the port)."""
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return dev


def _rank_main(fn, rank, world, backend, device, store, results, args,
               timeout_s):
    """One spawned rank: one thread of torch, the group from the shared
    FileStore, `fn`, its result (or traceback) reported before the group
    is destroyed, on every way out."""
    torch.set_num_threads(1)
    try:
        dev = torch.device("cuda", rank) if device is None \
            else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout_s))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        out = (rank, True, fn(rank, world, dev, *args))
    except BaseException:  # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    results.put(out)
    dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device, *args,
          timeout: float = 600.0):
    """Run ``fn(rank, world, device, *args)`` on `world` new processes
    joined in one process group on `backend`, and return the list of
    their results by rank (each must pickle).

    `device` is every rank's device ("cpu", "cuda:0", ...), or None for
    ``cuda:<rank>`` (one card a rank). The group meets through a
    `FileStore` in a fresh temporary directory, so concurrent callers
    never contend for a port. `fn` must be importable by name (a
    module-level function). A rank that raises or dies, or a run past
    `timeout` seconds, raises here after every rank has been stopped."""
    if device is None and world > torch.cuda.device_count():
        raise ValueError(f"device=None puts rank r on cuda:r; {world} ranks "
                         f"need {world} cards, found "
                         f"{torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done, failed, late = {}, {}, False
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world, backend, device, os.path.join(tmp, "store"),
                  results, args, timeout), daemon=True)
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world and not failed:
                if time.monotonic() > deadline:
                    late = True
                    break
                try:
                    r, ok, val = results.get(timeout=0.5)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if (r not in done and p.exitcode not in (None, 0)):
                            failed[r] = f"exited with code {p.exitcode}"
                    continue
                (done if ok else failed)[r] = val
            # the other ranks' failures (a peer of a failed rank fails in
            # its next collective) come within moments: report them all
            t_end = time.monotonic() + 2.0
            while failed and len(done) + len(failed) < world \
                    and time.monotonic() < t_end:
                try:
                    r, ok, val = results.get(timeout=0.2)
                    (done if ok else failed)[r] = val
                except queue.Empty:
                    pass
        finally:
            for p in procs:
                p.join(timeout=0.5 if failed or late else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if late:
        slow = sorted(set(range(world)) - set(done))
        raise TimeoutError(f"{backend} world {world}: ranks {slow} did not "
                           f"finish in {timeout} s")
    if failed:
        raise RuntimeError(f"{backend} world {world}: " + "\n".join(
            f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
    return [done[r] for r in range(world)]
