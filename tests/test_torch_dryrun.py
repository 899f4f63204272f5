"""The dry run's CLI (`python -m repro_torch.launch.dryrun`) in a
subprocess on SmolLM-135M train_4k, single pod (16 x 16 fake ranks, meta
tensors): an OK record with the reference's keys, and its
``memory.args`` equal to the same arithmetic over the reference's
sanitized spec trees and `abstract_params` (rank 0's shard of every
parameter, of ZeRO-1's float32 m and v, and of the tokens and targets;
the port's step count is a host integer, outside the device's bytes).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import get_config as r_config
from repro.distributed import sharding as R
from repro.models.model import abstract_params as r_abstract

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


class FakeMesh:
    shape = {"data": 16, "model": 16}


def _local_bytes(specs, tree, itemsize=None) -> int:
    """Bytes of rank 0's shards: each dimension divided by the sizes of
    the axes its (sanitized) spec names."""
    total = 0
    for sp, leaf in zip(jax.tree.leaves(specs,
                                        is_leaf=lambda x: isinstance(x, JP)),
                        jax.tree.leaves(tree)):
        dims = list(sp) + [None] * (len(leaf.shape) - len(sp))
        n = 1
        for d, ax in zip(leaf.shape, dims):
            axes = () if ax is None else ax if isinstance(ax, tuple) \
                else (ax,)
            n *= d // math.prod(FakeMesh.shape[a] for a in axes)
        total += n * (itemsize or np.dtype(leaf.dtype).itemsize)
    return total


def _reference_args_bytes() -> int:
    rcfg = r_config("smollm-135m")
    pa = r_abstract(rcfg)
    ps = R.sanitize(R.param_specs(rcfg), pa, FakeMesh())
    mv = R.opt_state_specs(ps, pa, FakeMesh())["m"]
    tok = jax.ShapeDtypeStruct((256, 4096), np.int32)
    return (_local_bytes(ps, pa) + 2 * _local_bytes(mv, pa, itemsize=4)
            + 2 * _local_bytes(JP("data", None), tok))


def test_dryrun_cli_smollm_train_4k(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--out", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC))
    want_args = _reference_args_bytes()  # beside the subprocess
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    short = json.loads(out.strip().splitlines()[-1])
    assert short["status"] == "OK", short
    rec = json.loads((tmp_path / "smollm-135m__train_4k__sp.json")
                     .read_text())
    for k in ("status", "n_devices", "memory", "cost", "collectives",
              "remat"):
        assert k in rec, k
    assert rec["n_devices"] == 256 and rec["remat"] == "block"
    assert rec["memory"]["args"] == want_args
    assert rec["memory"]["bytes_per_device"] == \
        rec["memory"]["args"] + rec["memory"]["temp"] > want_args
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    # ZeRO-1's reduce-scatter, the plan's all-reduces and all-gathers
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= \
        set(rec["collectives"])
