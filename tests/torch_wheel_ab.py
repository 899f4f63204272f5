"""`stage_rows` and `descent_tail` of this tree against another
checkout's, on one card, at one trial's shapes at n = 1e6.

    PYTHONPATH=src python tests/torch_wheel_ab.py OTHER_ROOT [--iters 50]

OTHER_ROOT is the root of another checkout of the repository from
before the kernels took per-trial arguments (e.g. the parent commit,
unpacked with `git archive`). Its ``enqueue.cu`` and ``descent.cu`` are
built by this tree's `kernels._build.compile_source` into
``build/wheel_ab/`` and launched through their one-trial C interfaces
(a host `t`; one `max_addr`); this tree's through its per-trial ones
with B = 1. Shapes: `stage_rows` on 1,049,088 rows of width 8 and 9
(`chip_smoke.py` phase 2's), `descent_tail` on 32,784 rows (the narrow
tail's width at n = 1e6), 80 % live, from a real ring's owner tables.
Each kernel is first held exactly against the plain version, then timed
with CUDA events over `--iters` back-to-back launches in the order
other, this, this, other. Prints the card's name and power limit and
one JSON line of milliseconds per launch. Needs a CUDA device; not
collected by pytest.
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

from repro_torch.core import addressing as A
from repro_torch.kernels import _build
from repro_torch.kernels.wheel import descent_reference, stage_rows_reference
from repro_torch.kernels.wheel._common import I32, I64, P, in_segment, stream_of
from repro_torch.kernels.wheel.descent import _ARGS as DESCENT_ARGS
from repro_torch.kernels.wheel.enqueue import _ARGS as STAGE_ARGS

# the one-trial C interfaces before the trial axis
OTHER_ARGS = {"enqueue": [P, P, P, P, I64, I64, I32, I32, P, P],
              "descent": [P] * 11 + [I32, I64] + [P] * 3}
SYMBOL = {"enqueue": "rt_stage_rows", "descent": "rt_descent_tail"}


def build_other(root: str, name: str) -> ctypes.CDLL:
    out = _build.REPO_ROOT / "build" / "wheel_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}_other.so"
    p = _build.compile_source(
        name, lib, Path(root) / "src" / "repro_torch" / "kernels" / "csrc")
    log, _ = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {root}:\n{log}")
    return ctypes.CDLL(str(lib))


def bound(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, SYMBOL[name])
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def stage_case(rng, dev, roww: int):
    m = 1_049_088
    rows = torch.from_numpy(rng.integers(0, 2**32, (m, roww), dtype=np.uint64)
                            .astype(np.int64)).to(dev)
    alert = torch.from_numpy(rng.random(m) < 0.15).to(dev)
    ordinal = (torch.cumsum(torch.from_numpy(rng.random(m) < 0.6).long(), 0)
               - 1).to(dev)
    perm = torch.from_numpy((rng.permutation(10) + 1).astype(np.int32)).to(dev)
    t, dt = 12345, roww - 1
    t_dev = torch.full((1,), t, dtype=torch.int32, device=dev)
    out = torch.empty_like(rows)
    want = stage_rows_reference(rows, alert, ordinal, perm[None], t_dev, dt)
    ins = (rows, alert, ordinal, perm)  # the closures keep them alive
    head = lambda: [x.data_ptr() for x in ins]
    s = stream_of(dev)
    calls = {"other": lambda f: f(*head(), t, m, roww, dt, out.data_ptr(), s),
             "this": lambda f: f(*head(), t_dev.data_ptr(), m, m, roww, dt,
                                 out.data_ptr(), s)}
    return calls, lambda: [out], [want]


def descent_case(rng, dev):
    n, d, m = 4096, 32, 32_784
    addrs = A.random_ring(n, d, seed=3).astype(np.int64)
    prev = np.roll(addrs, 1)
    pos = A.position_from_segment(torch.from_numpy(prev),
                                  torch.from_numpy(addrs), d).numpy()
    dest = rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.int64)
    own = np.searchsorted(addrs, dest, side="left") % n
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    a_prev, a_self = t(prev[own]), t(addrs[own])
    origin = t(addrs[rng.integers(0, n, m)])
    args = [origin, t(dest),
            t(rng.integers(0, 2**d, m, dtype=np.uint64).astype(np.int64)),
            t(rng.random(m) < 0.7), t(rng.random(m) < 0.8),
            t(rng.random(m) < 0.5), t(pos[own]), a_prev, a_self,
            in_segment(origin, a_prev, a_self), t(addrs[-1:])]
    want = descent_reference(*args, d)
    flags = torch.empty((3, m), dtype=torch.bool, device=dev)
    out = torch.empty((2, m), dtype=torch.int64, device=dev)
    ptrs = lambda: [x.data_ptr() for x in args]  # keeps `args` alive
    tail = (flags.data_ptr(), out.data_ptr(), stream_of(dev))
    calls = {"other": lambda f: f(*ptrs(), d, m, *tail),
             "this": lambda f: f(*ptrs(), d, m, m, *tail)}
    got = lambda: [flags[0], flags[1], out[0], out[1], flags[2]]
    return calls, got, list(want)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wheel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    fns = {name: {"other": bound(build_other(a.other_root, name), name,
                                 OTHER_ARGS[name]),
                  "this": bound(_build.library(name), name, args)}
           for name, args in (("enqueue", STAGE_ARGS),
                              ("descent", DESCENT_ARGS))}
    rng = np.random.default_rng(2026)
    cases = {"stage_rows w8": ("enqueue", stage_case(rng, dev, 8)),
             "stage_rows w9": ("enqueue", stage_case(rng, dev, 9)),
             "descent_tail": ("descent", descent_case(rng, dev))}
    res = {}
    for label, (name, (calls, got, want)) in cases.items():

        def timed(tag):
            fn = fns[name][tag]
            assert calls[tag](fn) == 0, f"{label} {tag}"
            torch.cuda.synchronize(dev)
            for g, w in zip(got(), want):
                assert torch.equal(g, w), f"{label} {tag} differs from plain"
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(a.iters):
                calls[tag](fn)
            e1.record()
            torch.cuda.synchronize(dev)
            return e0.elapsed_time(e1) / a.iters

        res[label] = {f"{tag}_{i}": timed(tag)
                      for i, tag in enumerate(("other", "this", "this",
                                               "other"))}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
