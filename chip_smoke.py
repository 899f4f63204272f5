#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), then, in order:

  1. prints the card's name and power limit and the kernel build time;
  2. holds each wheel kernel against its plain PyTorch version on the card
     at the n = 1e6 shapes (exact equality), and times kernel and plain;
  3. runs the engine with its kernels and with their plain versions, both
     on the card, at n = 4096 for 300 cycles: the full state must be equal;
  4. the main path at n = 100,000: converge at mu = 0.45, flip the votes to
     mu = 0.55 through `apply_coalesced`, converge again;
  5. n = 1,000,000 peers: the init storm and 200 cycles;
  6. prints one JSON line with every kernel's launches on the main path
     (phases 4 and 5), its error, times and bound; then a device-time
     profile of 10 cycles at n = 1e6.

Every phase asserts; the last line is the run's JSON verdict. Exits
non-zero without printing a result when no CUDA device is present or the
port's sources are missing. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32 peak; the int32 work
# of these kernels is priced at this rate (the data sheet lists no int32
# ALU rate)
N_BIG = 1_000_000
SOURCES = {
    "stage_rows": ("src/repro_torch/kernels/csrc/enqueue.cu",
                   "src/repro/kernels/wheel/enqueue.py:52"),
    "threshold_step": ("src/repro_torch/kernels/csrc/threshold_step.cu",
                       "src/repro/kernels/wheel/threshold_step.py:35"),
    "due_dedup": ("src/repro_torch/kernels/csrc/due_dedup.cu",
                  "src/repro/kernels/wheel/due_dedup.py:78"),
    "descent_tail": ("src/repro_torch/kernels/csrc/descent.cu",
                     "src/repro/kernels/wheel/descent.py:85"),
}
# integer operations per unit of work, counted from the CUDA sources
OPS_PER_ROW = {"stage_rows": 1, "threshold_step": 40, "due_dedup": 30,
               "descent_tail": 60}  # descent: per row-step


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call: CUDA events on the card."""
    import torch

    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / iters


def device_ms(fn, dev, iters: int) -> float:
    """Mean device milliseconds per call: the summed duration of the
    kernels (and copies) the call ran, from the profiler's device trace —
    host launch overhead and host syncs excluded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":  # CPU rehearsal of the script: wall time
        return time_ms(fn, dev, iters)
    fn()
    sync(dev)
    for _ in range(3):  # a session may come back empty: profile again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync(dev)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("the profiler recorded no device time")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(name: str, io_bytes: int, work: int):
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = work * OPS_PER_ROW[name] / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        d = (g.long() - w.long()).abs().max().item() if g.numel() else 0
        err = max(err, float(d))
    return err


def votes_at(n: int, mu: float, rng):
    import numpy as np

    v = np.zeros(n, np.int64)
    v[rng.choice(n, int(round(n * mu)), replace=False)] = 1
    return v


def make(n: int, dev, seed: int, mu: float, **kw):
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine

    rng = np.random.default_rng(seed)
    ring = Ring.random(n, 32, seed=seed)
    votes = votes_at(n, mu, rng)
    eng = make_engine("torch", ring, votes, seed=seed + 1, device=dev,
                      capacity_per_peer=8, **kw)
    return eng, votes, rng


# -- phase 2: kernels against their plain versions --------------------------

def capture_descent(n: int, dev, cycles: int):
    """The narrow-tail descent batch of a real cycle (the last of
    `cycles` after the init storm at n peers)."""
    eng, _, _ = make(n, dev, seed=7, mu=0.45)
    seen = {}
    real = eng._descent

    def grab(*args, **kw):
        seen["args"], seen["d"] = args, args[-1]
        return real(*args, **kw)

    eng._descent = grab
    eng.step(cycles)
    sync(dev)
    eng._descent = real
    return seen["args"], eng


def descent_row_steps(args) -> int:
    """Row-steps of the descent loop on these inputs (its data-dependent
    work), counted with the plain loop's own rules."""
    import torch
    from repro_torch.engine import protocol as proto
    from repro_torch.kernels.wheel._common import in_segment

    (origin, dest, edge, he, live, entry, pos_i, a_prev, a_self, sseg,
     max_addr, d) = args
    lv, ent, cd, ce, ch = live, entry, dest, edge, he
    steps = 0
    while bool(lv.any()):
        steps += int(lv.sum())
        dlv = proto.deliver_rules(
            origin=origin, dest=cd, edge=ce, has_edge=ch, network_entry=ent,
            pos_i=pos_i, a_prev=a_prev, a_self=a_self, self_seg=sseg,
            max_addr=max_addr, d=d)
        stay = (lv & ~dlv.accept & ~dlv.drop
                & in_segment(dlv.new_dest, a_prev, a_self))
        ent = ent & ~stay
        cd = torch.where(stay, dlv.new_dest, cd)
        ce = torch.where(stay, dlv.new_edge, ce)
        ch = torch.where(stay, dlv.new_has_edge, ch)
        lv = stay
    return steps


def phase_kernels(dev, sizes, iters: int) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.engine.problems import Majority
    from repro_torch.kernels import wheel as W

    rng = np.random.default_rng(2026)
    rows = {}

    def check(name, kernel, plain, args, work, piters):
        want = plain(*args)
        got = kernel(*args)
        sync(dev)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        assert err == 0, f"{name}: kernel differs from its plain version"
        io = nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *got)
        call = time_ms(lambda: kernel(*args), dev, iters)
        pcall = time_ms(lambda: plain(*args), dev, piters, warmup=1)
        ms = device_ms(lambda: kernel(*args), dev, iters)
        pms = device_ms(lambda: plain(*args), dev, piters)
        b_ms, by = bound(name, io, work)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": None}
        log(f"  {name:15s} equal (max_abs_err 0)  device: kernel {ms:.4f} ms,"
            f" plain {pms:.4f} ms, bound {b_ms:.4f} ms ({by}); per call "
            f"with launch: kernel {call:.4f} ms, plain {pcall:.4f} ms  "
            f"[{io / 1e6:.1f} MB moved]")

    # stage_rows: the staged block, lanes * 4 * window_l rows of width 8
    m = sizes["staged"]
    vals = torch.from_numpy(
        rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.int64))
    mask = torch.from_numpy(rng.random(m) < 0.6)
    args = (vals.to(dev), torch.from_numpy(rng.random(m) < 0.15).to(dev),
            (torch.cumsum(mask.long(), 0) - 1).to(dev),
            torch.from_numpy((rng.permutation(10) + 1).astype(np.int32)).to(dev),
            0xFFFFFFFF - 4, 7)  # the stamp wraps at 32 bits
    check("stage_rows", W.stage_rows, W.stage_rows_reference, args,
          m, max(1, iters // 4))

    # threshold_step: one row per window row
    ww = sizes["window"]
    mk = lambda shape, lo, hi: torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int32)).to(dev)
    prob = Majority()
    args = (mk((ww, 3, 2), 0, 60), mk((ww, 3, 2), 0, 60), mk((ww, 1), 0, 2))
    check("threshold_step", lambda *a: W.threshold_step(prob, *a),
          lambda *a: W.threshold_step_reference(prob, *a), args, ww,
          max(1, iters // 4))

    # due_dedup: uniform links, then many rows sharing a link
    nl = sizes["links"]
    shared = min(30_000, nl // 24)
    for links in (nl // 3, shared):
        flat = torch.from_numpy(rng.integers(0, links, ww) * 3
                                + rng.integers(0, 3, ww)).to(dev)
        acc = rng.random(ww) < 0.6
        alert = rng.random(ww) < 0.05
        args = (flat, torch.from_numpy(acc & ~alert).to(dev),
                torch.from_numpy(acc & alert).to(dev), mk(ww, 0, 50),
                mk(ww, 0, 50), nl)
        if links == shared:
            got, want = W.due_dedup(*args), W.due_dedup_reference(*args)
            sync(dev)
            assert max_abs_err(got, want) == 0, "due_dedup (shared links)"
            log(f"  {'due_dedup':15s} equal with ~{ww // links} rows per link")
        else:
            check("due_dedup", W.due_dedup, W.due_dedup_reference, args,
                  ww, max(1, iters // 4))

    # descent_tail: the narrow-tail batch of a real cycle
    dargs, eng = sizes["descent"]
    steps = descent_row_steps(dargs)
    check("descent_tail", W.descent_tail, W.descent_reference, dargs,
          steps, max(1, iters // 8))
    log(f"  descent batch: {dargs[0].shape[0]} rows, "
        f"{int(dargs[4].sum())} live, {steps} row-steps")
    del eng
    return rows


# -- phase 3: the engine with kernels vs with plain versions ---------------

def phase_parity(dev, n: int, cycles: int) -> None:
    import numpy as np
    from repro_torch.engine.convert import state_to_numpy

    a, _, _ = make(n, dev, seed=11, mu=0.45)
    b, _, _ = make(n, dev, seed=11, mu=0.45, wheel_kernels="none")
    for done in range(0, cycles, 50):
        k = min(50, cycles - done)
        a.step(k)
        b.step(k)
        sa, sb = state_to_numpy(a._st), state_to_numpy(b._st)
        for f in sa:
            assert np.array_equal(sa[f], sb[f]), \
                f"state field {f} differs after {done + k} cycles"
    assert a.dropped == 0
    log(f"  n={n}: kernels-on and plain engines equal in full state after "
        f"{cycles} cycles (t={a.t}, messages={a.messages_sent}, "
        f"deferred={a.deferred})")


# -- phases 4 and 5: the main path -------------------------------------------

def phase_converge(dev, n: int) -> dict:
    eng, votes, rng = make(n, dev, seed=3, mu=0.45)
    out = {}
    for stage, mu in ((1, None), (2, 0.55)):
        if mu is not None:
            new = votes_at(n, mu, rng)
            chg = (new != eng.votes()).nonzero()[0]
            eng.apply_coalesced(chg, new[chg])
            votes = new
        truth = int(2 * votes.sum() >= n)
        sync(dev)
        t0, c0 = time.perf_counter(), eng.t
        res = eng.run_until_converged(truth=truth, max_cycles=20_000)
        sync(dev)
        dt = time.perf_counter() - t0
        cyc = eng.t - c0
        assert res["converged"] == 1.0, f"stage {stage} did not converge"
        assert eng.dropped == 0, "messages dropped"
        eng.check_conservation()
        assert (eng.outputs() == truth).all()
        out[f"stage{stage}"] = dict(cycles=cyc, t=res["cycles"],
                                    messages_per_peer=res["messages"] / n,
                                    cycles_per_s=cyc / dt, seconds=dt)
        log(f"  n={n} stage {stage} (mu={mu or 0.45}): converged to {truth} in "
            f"{cyc} cycles, {res['messages'] / n:.3f} messages/peer, "
            f"{cyc / dt:.1f} cycles/s, dropped 0, conservation holds")
    return out


def phase_big(dev, n: int, cycles: int):
    sync(dev)
    t0 = time.perf_counter()
    eng, _, _ = make(n, dev, seed=5, mu=0.45)
    sync(dev)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.step(cycles)
    sync(dev)
    dt = time.perf_counter() - t0
    assert eng.dropped == 0, "messages dropped at n=1e6"
    cons = eng.check_conservation()
    log(f"  n={n}: init storm {t_init:.2f} s (pad {eng.pad}, wheel "
        f"{nbytes(eng._st.wheel) / 1e9:.2f} GB); {cycles} cycles in "
        f"{dt:.2f} s = {cycles / dt:.1f} cycles/s; deferral_rate "
        f"{eng.deferral_rate:.4f}; in flight {cons['live']}; dropped 0, "
        f"conservation holds")
    return eng, {"init_s": t_init, "cycles_per_s": cycles / dt,
                 "deferral_rate": eng.deferral_rate}


def phase_profile(dev, eng, cycles: int) -> None:
    """Device time by kernel over a short window of cycles (device-side
    events only: kernels, copies, memsets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.step(2)
    sync(dev)
    t0 = time.perf_counter()
    eng.step(cycles)
    sync(dev)
    wall0 = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step(cycles)
        sync(dev)
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ev)
    launches = sum(e.count for e in ev)
    log(f"  profile of {cycles} cycles at n={eng.n}: wall {wall0 * 1e3 / cycles:.2f}"
        f" ms/cycle unprofiled, {wall * 1e3 / cycles:.2f} profiled; device "
        f"busy {dev_us / 1e3 / cycles:.2f} ms/cycle in {launches / cycles:.0f}"
        f" device launches ({100 * dev_us / 1e3 / (wall0 * 1e3):.0f}% of the "
        f"unprofiled wall)")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / cycles:9.1f} us/cycle "
            f"{e.count / cycles:5.1f}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.kernels.wheel import launch_counts, reset_launches

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card)
    t0 = time.perf_counter()
    out = _build.build_all()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s) into {out}")
    for src, rep in _build.BUILD_INFO.get("ptxas", {}).items():
        for line in rep.splitlines():
            if "Used" in line:
                log(f"  {src}: {line.strip()}")

    log("phase 2: kernels vs plain versions at the n = 1e6 shapes")
    # the first profiler sessions of a process can drop device events:
    # warm the profiler up before any measurement
    x = torch.ones(1 << 20, device=dev)
    device_ms(lambda: x.mul_(1.0), dev, 20)
    dargs, eng_a = capture_descent(N_BIG, dev, cycles=12)
    sizes = {"staged": eng_a.lanes * 4 * eng_a.window_l,
             "window": eng_a.lanes * eng_a.window_l,
             "links": eng_a.pad * 3, "descent": (dargs, eng_a)}
    log(f"  shapes: pad {eng_a.pad}, {eng_a.lanes} lanes, lane_budget "
        f"{eng_a.lane_budget}, window_l {eng_a.window_l}, WW {sizes['window']}"
        f", narrow NT {dargs[0].shape[0]}, staged rows {sizes['staged']}")
    rows = phase_kernels(dev, sizes, iters=20)
    del eng_a, sizes, dargs
    torch.cuda.empty_cache()

    log("phase 3: engine parity, kernels vs plain versions, on the card")
    phase_parity(dev, 4096, 300)

    log("phase 4: main path at n = 100,000")
    reset_launches()
    conv = phase_converge(dev, 100_000)
    log("phase 5: n = 1,000,000 peers")
    big, big_stats = phase_big(dev, N_BIG, 200)
    launches = launch_counts()
    for name, k in launches.items():
        assert k > 0, f"kernel {name} was not launched on the main path"

    log("phase 6: kernels on the main path (phases 4 and 5)")
    table = []
    for name, (src, rep) in SOURCES.items():
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[name],
                      **rows[name]})
    phase_profile(dev, big, 10)
    del big
    log(f"summary: {json.dumps({'converge_1e5': conv, 'n_1e6': big_stats})}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
