"""Dry run of the sharding plan: every (arch x shape x mesh) cell on the
production meshes, on meta tensors (the port's `repro.launch.dryrun`).

For each cell, in a process of its own:
  1. a fake process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks,
     this process being rank 0 (`torch.testing`'s ``FakeStore``: its
     collectives complete at once and move nothing);
  2. the production mesh (`launch.mesh.make_production_mesh`);
  3. meta parameters, optimizer state and inputs (nothing allocated),
     placed as DTensors by `sanitize(param_specs)`,
     `opt_state_specs(zero1=True)` and `input_specs_for` / `cache_specs`
     (`distributed.sharding.distribute`);
  4. the cell's train, prefill or decode step (`launch.steps`) run once
     under `analysis.counts`: rank 0's dot FLOPs, byte model, collective
     bytes by kind and peak temporary bytes.

The record keeps the reference's keys. ``memory.args`` is the bytes of
rank 0's shards of parameters, optimizer state and inputs (or cache);
``memory.temp`` the peak bytes of the storages the step allocated
(`counts.Counter`); ``memory.bytes_per_device`` their sum. ``cost.flops``
and ``cost.bytes_accessed`` are per device. No time is measured: a meta
run computes nothing, and `analysis.roofline` prices the counts at the
H100's datasheet rates.

Train cells run with ``remat="block"`` (``--remat auto``), as the
reference's. On the meta device the flash kernel's forward, one
operator of torch's dispatcher, makes only its outputs' shapes and is
charged by `analysis.counts.KERNEL_FLOPS`. long_500k on a
full-attention arch is SKIP, as the reference's. A cell that meets an
op DTensor cannot place is a FAIL record with the error and the op, and
so is a step that runs past `CELL_TIMEOUT_S` (a serial loop that the
step walks op by op on the meta device, the sLSTM's scan over 32k
tokens, takes minutes).

Usage (the CPU; the dry run never touches a card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k [--multi-pod] [--out results/torch/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import counts
from repro_torch.configs import base as cbase
from repro_torch.configs.registry import ARCH_IDS, get_config, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import abstract_params
from repro_torch.optim.adamw import AdamWConfig, init_state

SHAPES = {s.name: s for s in cbase.ALL_SHAPES}
# seconds a cell's step may run before it fails: the slowest cell,
# xLSTM-350M prefill_32k, walks the sLSTM's per-token loop op by op in
# 11-19 minutes on an 8-core host
CELL_TIMEOUT_S = 1800.0


def init_fake_group(multi_pod: bool) -> None:
    """This process as rank 0 of a fake group of the production mesh's
    size (replacing any fake group of the other size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _failing_op(exc: BaseException) -> str:
    """The op named in a DTensor error ('aten.foo.default'), else ''."""
    import re
    m = re.search(r"\b(aten\.[\w.]+|_c10d_functional\.[\w.]+)", str(exc))
    return m.group(1) if m else ""


def count_step(cfg, shape: cbase.ShapeConfig, mesh) -> Tuple[int, Dict]:
    """(rank 0's argument bytes, `counts.flops_and_bytes`' counts) of
    `shape`'s train, prefill or decode step of `cfg` on meta tensors
    placed on `mesh` by the plan (a `DeviceMesh` of the default group,
    which may be a fake one); the step raises TimeoutError past
    `CELL_TIMEOUT_S`."""
    params_abs = abstract_params(cfg)
    pspecs = shd.sanitize(shd.param_specs(cfg), params_abs, mesh)
    ins = input_specs(cfg, shape)
    in_sh = shd.input_specs_for(cfg, shape, mesh)
    if "cache" in ins:
        in_sh["cache"] = shd.sanitize(in_sh["cache"], ins["cache"], mesh)
    params = shd.distribute(params_abs, pspecs, mesh)
    inputs = shd.distribute(ins, in_sh, mesh)
    fe = (inputs["frontend_embeds"],) if cfg.frontend \
        and "frontend_embeds" in inputs else ()
    args_bytes = shd.local_bytes(params) + shd.local_bytes(inputs)
    if shape.kind == "train":
        ospecs = shd.opt_state_specs(pspecs, params_abs, mesh, zero1=True)
        opt = shd.distribute(init_state(params_abs), ospecs, mesh)
        args_bytes += shd.local_bytes(opt)
        step = S.make_train_step(cfg, AdamWConfig())
        run = lambda: step(params, opt, inputs["tokens"], inputs["targets"],
                           *fe)
    elif shape.kind == "prefill":
        step = S.make_prefill_step(cfg, cache_len=None)
        run = lambda: step(params, inputs["tokens"], *fe)
    else:
        step = S.make_decode_step(cfg)
        run = lambda: step(params, inputs["token"], inputs["cache"])
    _, c = counts.flops_and_bytes(
        run, deadline=time.monotonic() + CELL_TIMEOUT_S)
    return args_bytes, c


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               remat: str = "auto", extra_overrides: Dict[str, Any] = None,
               moe_impl: str = None, seq_shard: bool = False) -> Dict:
    """One cell's record (the fake group must be initialised at the
    mesh's size: `init_fake_group`); the step raises TimeoutError past
    `CELL_TIMEOUT_S`."""
    cfg = get_config(arch)
    if seq_shard:
        from repro_torch.distributed.sp import set_sp_axes
        cfg = dataclasses.replace(cfg, seq_shard=True)
        set_sp_axes(("pod", "data") if multi_pod else ("data",), "model")
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cbase.sub_quadratic(cfg):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "SKIP", "reason": "full-attention arch (DESIGN.md)"}
    if remat == "auto":
        remat = "block" if shape.kind == "train" else "none"
    cfg = dataclasses.replace(cfg, remat=remat, **(extra_overrides or {}))

    t0 = time.time()
    mesh = make_production_mesh(multi_pod)
    args_bytes, c = count_step(cfg, shape, mesh)
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "OK", "remat": remat,
        "n_devices": dist.get_world_size(),
        "mesh": "x".join(str(n) for n in mesh.shape),
        "run_s": round(time.time() - t0, 1),
        "memory": {"bytes_per_device": args_bytes + c["peak_bytes"],
                   "temp": c["peak_bytes"], "args": args_bytes},
        "cost": {"flops": c["flops"], "bytes_accessed": c["bytes"],
                 "kernel_scope_flops": c["kernel_scope_flops"],
                 "kernel_scope_bytes": c["kernel_scope_bytes"]},
        "collectives": c["collectives"],
    }


def run_cell(arch: str, shape: str, multi_pod: bool, **kw) -> Dict:
    """`lower_cell` with the fake group set up, a failure (a timeout too)
    as a FAIL record: the error, and the op at fault where the error
    names one."""
    init_fake_group(multi_pod)
    try:
        return lower_cell(arch, shape, multi_pod, **kw)
    except Exception as e:  # recorded, as the reference's main records it
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "FAIL", "op": _failing_op(e),
                "error": f"{type(e).__name__}: {e}"[:2000],
                "trace": traceback.format_exc()[-2000:]}


def tag(rec: Dict) -> str:
    return f"{rec['arch']}__{rec['shape']}__" \
           f"{'mp' if rec['multi_pod'] else 'sp'}"


def summary(rec: Dict) -> Dict:
    short = {k: rec.get(k) for k in
             ("arch", "shape", "multi_pod", "status", "run_s")}
    if rec["status"] == "OK":
        short["flops"] = f"{rec['cost']['flops']:.3e}"
        short["coll_bytes"] = f"{sum(rec['collectives'].values()):.3e}"
        short["mem_GB"] = round(rec["memory"]["bytes_per_device"] / 2**30, 2)
    elif rec["status"] == "FAIL":
        short["op"] = rec["op"]
        short["error"] = rec["error"][:160]
    return short


def run_cells(cells: Iterable[Tuple[str, str, bool]],
              out: Optional[str] = None, **kw) -> List[Dict]:
    """Each (arch, shape, multi_pod) cell's record, in turn, each written
    to `out` (a directory) when given and its summary printed."""
    recs = []
    for arch, shape, multi_pod in cells:
        rec = run_cell(arch, shape, multi_pod, **kw)
        if out:
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, tag(rec) + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        print(json.dumps(summary(rec)), flush=True)
        recs.append(rec)
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="auto")
    ap.add_argument("--moe-impl", default=None,
                    choices=(None, "gather", "ep_a2a"))
    ap.add_argument("--out", default="results/torch/dryrun")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s, args.multi_pod) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]
    torch.set_num_threads(1)
    run_cells(cells, args.out, remat=args.remat, moe_impl=args.moe_impl)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
