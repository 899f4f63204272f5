"""The general L2 `threshold_step` kernel of this tree against the one of
another checkout, on one card, at `chip_smoke.py` phase 2's two shapes.

    PYTHONPATH=src python tests/torch_l2_ab.py OTHER_ROOT [--iters 20]

OTHER_ROOT is the root of another checkout of the repository (e.g. the
parent commit, unpacked with `git archive`). Its
``src/repro_torch/kernels/csrc/threshold_step.cu`` is built by this
tree's `kernels._build.compile_source` into ``build/l2_ab/``, and both
libraries' `rt_threshold_step_l2_general` are launched on the same
inputs: D = 9, M = 18 at 2^21 rows (the event react's pad rows at
n = 1e6) and D = 16, M = 1,024 at 262,272 rows (the drain window's).
Each is first held exactly against the plain version, then timed with
CUDA events over `--iters` back-to-back launches in the order other,
this, this, other.
Then this tree's kernel alone at D = 9 and 2^21 rows with covers of 1,
18 and 36 directions (the default cover's first direction, the cover,
the cover twice): the cost of the rows alone and the cost a direction.
Prints the card's name and power limit and one JSON line of milliseconds
per launch. Needs a CUDA device; not collected by pytest.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.engine.problems import L2Thresh
from repro_torch.kernels import _build
from repro_torch.kernels.wheel import threshold_step_reference
from repro_torch.kernels.wheel._common import stream_of
from repro_torch.kernels.wheel.threshold_step import _ARGS_L2

SHAPES = ((9, 18, 2**21, None), (16, 1024, 262_272, None),
          (9, 18, 2**21, 1), (9, 18, 2**21, 36))  # (D, M, rows, cover cut)


def build_other(root: str) -> ctypes.CDLL:
    out = _build.REPO_ROOT / "build" / "l2_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libthreshold_step_other.so"
    p = _build.compile_source(
        "threshold_step", lib,
        Path(root) / "src" / "repro_torch" / "kernels" / "csrc")
    log, _ = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {root}:\n{log}")
    return ctypes.CDLL(str(lib))


def inputs(rng, n: int, dim: int, dev):
    """chip_smoke.py phase 2's L2 rows: payloads in [-768, 768], counts
    0..3, a quarter of the rows with a zero vector sum (every half-space
    ties)."""
    ip = rng.integers(-768, 769, (n, 3, dim + 1)).astype(np.int32)
    op = rng.integers(-768, 769, (n, 3, dim + 1)).astype(np.int32)
    ip[..., dim] = rng.integers(0, 4, (n, 3))
    op[..., dim] = rng.integers(0, 4, (n, 3))
    x = rng.integers(-512, 513, (n, dim)).astype(np.int32)
    q = n // 4
    ip[:q, :, :dim] = 0
    x[:q] = 0
    return tuple(torch.from_numpy(a).to(dev) for a in (ip, op, x))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_l2_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    fns = {}
    for tag, lib in (("other", build_other(a.other_root)),
                     ("this", _build.library("threshold_step"))):
        fn = lib.rt_threshold_step_l2_general
        fn.argtypes, fn.restype = _ARGS_L2, ctypes.c_int
        fns[tag] = fn
    rng = np.random.default_rng(2026)
    res = {}
    for dim, ndirs, n, cut in SHAPES:
        prob = L2Thresh(tau=1.0, dim=dim, ndirs=ndirs)
        if cut is not None:  # the cover's first `cut` directions, repeated
            prob.U = np.ascontiguousarray(np.resize(prob.U, (cut, dim)))
        u = torch.from_numpy(prob.U).to(dev)
        args = inputs(rng, n, dim, dev)
        want = threshold_step_reference(prob, *args)
        outs = (torch.empty((n, 3), dtype=torch.bool, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty((n, 3, dim + 1), dtype=torch.int32, device=dev))

        def launch(tag):
            rc = fns[tag](*(t.data_ptr() for t in args), u.data_ptr(),
                          u.shape[0], dim, float(prob.Tf), n,
                          *(t.data_ptr() for t in outs), stream_of(dev))
            assert rc == 0, f"{tag}: CUDA error {rc}"

        def timed(tag):
            launch(tag)
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(a.iters):
                launch(tag)
            e1.record()
            torch.cuda.synchronize(dev)
            return e0.elapsed_time(e1) / a.iters

        tags = list(fns) if cut is None else ["this"]
        for tag in tags:
            for t in outs:
                t.zero_()
            launch(tag)
            torch.cuda.synchronize(dev)
            for g, w in zip(outs, want):
                assert torch.equal(g, w), f"{tag} differs from the plain " \
                    f"version at D={dim}, M={ndirs}"
        key = f"D{dim} M{u.shape[0]} n{n}"
        if cut is not None:
            ms = [timed("this"), timed("this")]
            res[key] = {"this_ms": ms}
            print(f"{key}: exact; this {ms[0]:.4f}, {ms[1]:.4f} ms a launch",
                  flush=True)
            continue
        order = ("other", "this", "this", "other")
        ms = [timed(tag) for tag in order]
        res[key] = {"other_ms": [ms[0], ms[3]], "this_ms": [ms[1], ms[2]]}
        print(f"{key}: both exact; other {ms[0]:.4f}, {ms[3]:.4f} ms; this "
              f"{ms[1]:.4f}, {ms[2]:.4f} ms a launch", flush=True)
        del args, want, outs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
