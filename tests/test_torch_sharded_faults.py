"""The fault plane of the sharded engine on the CPU, over gloo.

The differential harness's four `FAULT_GRID` schedules (crash with
eviction, drop and delay with the probe-only detector) replayed at world
2, one spawned process a rank, must equal `TorchEngine`'s replay: the
gathered state at every event boundary, the eviction timeline, the loss
tally and the rest of the trajectory on every rank (a crash cell's
resize event re-partitions the engine while the victim is dead but not
yet evicted, `resize_mesh`). And the crash guards hold on a sharded
engine.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.core.dht import Ring
from repro_torch.engine import FaultConfig, make_engine
from repro_torch.launch.mesh import spawn
from tests import _diff_harness as H
from tests import torch_sharded_ranks as R


@pytest.mark.parametrize("cell", H.FAULT_GRID,
                         ids=[f"{p}-{s}-{m}" for p, s, m in H.FAULT_GRID])
def test_fault_grid_world2(cell):
    spec = R.spec_of(H.make_schedule(cell[0], cell[1], faults=cell[2]),
                     H.make_problem(cell[0]))
    want = R.replay(R.build(spec, "cpu", 0), spec)
    got = spawn(R.replay_rank, 2, "gloo", "cpu", spec, timeout=300.0)
    R.assert_same_replay(want, got, str(cell))
    assert got[0]["lost"] > 0
    if cell[2] == "crash":
        assert len(got[0]["evictions"]) == 1


def test_crash_guards_sharded():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            ring = Ring.random(16, 10, seed=7)
            votes = (np.arange(16) % 3 == 0).astype(np.int64)
            plain = make_engine("torch", ring, votes, device="cpu", mesh=True)
            with pytest.raises(RuntimeError):
                plain.crash(0)
            eng = make_engine("torch", ring, votes, device="cpu", mesh=True,
                              faults=FaultConfig(suspect_after=10,
                                                 evict_after=40))
            with pytest.raises(IndexError):
                eng.crash(99)
            eng.crash(3)
            with pytest.raises(ValueError):  # already dead
                eng.crash(3)
            assert eng.dead_mask()[3] and eng.dead_mask().sum() == 1
            eng.step(120)
            assert [a for _, a in eng.evictions] == [int(ring.addrs[3])]
        finally:
            dist.destroy_process_group()
