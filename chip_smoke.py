#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), then, in order:

  1. prints the card's name and power limit and the kernel build time,
     each kernel's registers as ptxas reports them, and the count of
     HGMMA (wgmma) instructions in each `flash_attention_fwd`
     instantiation from `cuobjdump -sass` (bf16 > 0: the tensor cores;
     float32 0; bf16 D = 256 and MLA's 192 / 128 with no spills), and
     the general L2
     kernel's registers, static shared memory and spills;
  2. holds each kernel against its plain PyTorch version on the card at
     the n = 1e6 shapes (exact equality), and times kernel and plain: the
     four wheel kernels (`stage_rows` at row width 8 and at the L2 path's
     width 9; `due_dedup` on uniform links, on many rows per link, on
     every direction of many peers, then on those windows in turn on one
     scratch), the mean and L2 forms of `threshold_step` at the drain
     window (WW rows) and the event react (pad rows), the general L2
     kernel at D = 9 (M = 18, pad rows) and with a 16,384-float cover
     (D = 16, M = 1,024, WW rows; beside its bound, the unfused
     FP32 issue-rate floor), each with its launch shape, `majority_step`
     at pad rows, and `descent_tail` on a real cycle's narrow tail beside
     the card's launch floor (the device time of `torch.zeros(1)`); then
     the L2 forms' CUDA tests (tests/test_torch_cuda.py, the general
     kernel's tiling cases among them) in a pytest process of their own;
  3. runs the engine with its kernels and with their plain versions, both
     on the card, at n = 4096: majority, mean (tau 0.3) and L2 (tau 1,
     D 2) through 60 cycles, a data flip and 8 churn events
     20 cycles apart; majority without the threshold kernel (its event
     react runs `majority_step`) through the same; L2 at D = 9 (the
     general kernel, whose launches count under a name of their own)
     through a data flip. The full state must be equal after every stage
     and every churn event; the churn cells' kernels-on digests are kept
     for phase 17;
  4. the majority main path at n = 100,000: converge at mu = 0.45, flip
     the votes to mu = 0.55 through `apply_coalesced`, converge again;
  5. n = 1,000,000 majority peers: the init storm and 100 cycles, then a
     device-time profile of 10 cycles;
  6. mean and L2 at n = 100,000 through the golden-cell script: converge,
     a full-width data flip through `apply_coalesced`, one join and one
     leave, converge again;
  7. L2 at n = 1,000,000: the init storm, then 100 cycles with 16 churn
     events; then a device-time profile of 10 cycles and of one join;
  8. the training substrate's three kernels against their plain versions
     at the trainer's shapes: `threshold_gate` exactly (SmolLM-135M's
     134,515,008 parameters as one ragged flat tensor; tau <= 0 on a
     ragged 1,000,003), `rglru_scan` at (1, 4096, 4096) bf16 (forward
     and the reverse scan, each timed with the L2 evicted, a = 1 with u
     in eighths exactly, and the Function's backward),
     `flash_attention_fwd` o and lse at RecurrentGemma-9B's
     (1, 16 / 1, 4096, 256) window-2048 band and SmolLM-135M's
     (4, 9 / 3, 2048, 64) causal GQA, bf16, each beside
     `scaled_dot_product_attention` on the same inputs, with the SM
     clock and power nvidia-smi samples under each of the two;
  9. the trainer on RecurrentGemma-9B at full width, depth 3 (one
     pattern period), batch 1 x 4096, 4 steps (`run_plain`); its first
     step against the same step with every kernel's plain version; then
     a device-time profile of one step;
 10. the trainer on SmolLM-135M (full config) in threshold mode, 2 pods,
     compress tau 1e-4, max inner 4, batch 8 x 2048, 12 steps
     (`run_threshold`), and the same run with plain kernels;
 12. the fault plane, kernels-on vs plain engines in lockstep event by
     event: the differential harness's four fault schedules (majority
     404 crash, mean 505 crash, majority 606 drop, L2 707 drop), drawn
     here from their seeds, and the majority crash schedule without the
     threshold kernel (`majority_step` armed); full state, evictions and
     losses equal;
 13. the fault plane at scale: majority at n = 1,000,000 armed with
     drops and delays (p 0.1 / 0.05, probe-only detector) run toward
     its truth for at most 2,000 cycles (converged or not, it says
     which) and 30 cycles more, with `descent_tail`, `threshold_step`
     and `stage_rows` held exactly against their plain versions on the
     armed cycle's own inputs (the first cycle of each run and each one
     1.5 times wider than the widest checked; their rows printed beside
     phase 2's), then a device-time profile; majority at n = 100,000 with
     16 peers crashed at spread addresses (suspect 25, evict 150),
     stepped until the detector evicted exactly them, then reconverged;
     and the same on ring seed 7, where the reference's detector also
     evicts a live neighbour of a crashed peer: every crashed peer must
     go, the live ones evicted are reported. On seed 41 an
     `EngineSuspicionBridge` (`runtime.fault_tolerance`) syncs after
     every dispatch: it must suspect each crashed peer before its
     eviction;
 14. L2 at D = 9 with its default cover (M = 18: the general kernel) at
     n = 1,000,000: the init storm and 100 cycles, the kernel held
     exactly against its plain version on clones of its inputs on 2 more
     cycles, then a device-time profile of 10 cycles with the general
     kernel's share;
 15. batched trials (`make_engine(..., batch=B)`): kernels-on batched
     engines against B serial kernels-on engines at n = 4096 (B = 4
     majority on 4 rings, B = 3 L2 at D = 2 on one ring) through
     converge, a ragged `set_votes` and a second convergence run with
     the trials at different t, full state per trial equal; the paper's
     sweep grid (margins 0.40-0.60 x 4 seeds, drawn as
     `benchmarks/sweep.py` draws them, B = 24) at n = 100,000 to
     convergence, every trial on its truth with dropped 0, then a ragged
     flip and 3 cycles with each trial at its own t; B = 4 majority at
     n = 1,000,000 on 4 rings (wheel reckoned first), the init storm and
     100 cycles, profiled. On both the four wheel kernels are held
     exactly against their plain versions on the batched cycle's own
     inputs (`CycleKernelCheck`: the sweep's first cycle, each change
     of the stepping trials, the first per-trial-t cycle; cycles 0, 50
     and 99 at 1e6), and the `batched` path's launches are read in one
     window around these two engines. Then the sweep's slowest and
     fastest trial re-run serially (equal cycles, messages, outputs; one
     launch of each wheel kernel a cycle on both), the per-margin
     table, trial-cycles/s, a 10-cycle profile of a twin engine and the
     peak memory;
 16. the serve layer: the differential harness's three serve schedules
     (drawn here by a copy of its generator, at n = 4096) through a
     `ThresholdServer` over the kernels-on engine and over the plain
     one (transitions, outputs after every flush, counters and full
     state equal; conservation after every flush); majority at
     n = 100,000, window 8, 16 bursts of 250 updates with a join and a
     leave each, every burst pumped until settled: updates/s, settle
     latencies in cycles and ms, transitions (each kept as a digest),
     dropped 0;
 17. the sharded engine (`make_engine(..., mesh=)`, one process a rank
     through `launch.mesh.spawn`): world 1 on NCCL and worlds 2 and 4 on
     gloo, every rank on this card. Each world runs phase 3's majority
     churn cell, and world 2 also its mean, L2 and no-threshold cells,
     the plain majority engine and phase 12's first fault schedule armed;
     every rank's gathered state must equal, by sha256 of every field,
     the kernels-on single engine's at each check of phases 3 and 12,
     where that engine equalled the plain one. Each world runs phase 4
     (n = 100,000, the same stage cycles), its wheel kernels held exactly
     against their plain versions on its first cycle, each wheel kernel
     launched once a cycle on every rank, rank 0 profiled, the exchange
     timed alone; world 1 also runs phase 5 (n = 1,000,000), equal to its
     engine in every state field, outputs and counters. The same two jobs
     then run the control plane on the same groups: the tree collectives
     (`core.tree_collectives`: reduce, broadcast and all-reduce of
     float32, bfloat16 and int64 tensors on the card, bit-identical to
     the host replay of the reference's schedule; a 4-byte and a 64 MiB
     `tree_all_reduce` timed beside `dist.all_reduce`), phase 16's serve
     load over the sharded engine (all 16 bursts at world 1, the first
     `SERVE_BURSTS_MULTI` at worlds 2 and 4, from phase 16's state once
     its init storm settled: rank 0's server leads, the others follow;
     updates/s and settle latencies; transitions,
     settle cycles and the cycle count equal to phase 16's over the
     same bursts) and, in the 4-rank job, `resize_mesh` through phase
     3's majority churn cell (4 -> 2 -> 4 -> 1 -> 4 ... ranks, one
     resize after every second check; the state equal to phase 3's
     digests at every check). NCCL at world 2 or 4 runs only with a card a rank;
 18. the control plane in this process: `runtime.elastic`'s
     `churn_drill` (8 joins and leaves one cycle apart, which break
     convergence: the drill must reconverge) and
     `decision_latency_profile` (16 trials, one batched engine) at 4,096
     hosts, with every kernel and with every plain version, equal;
     SmolLM-135M (full config) through `run_plain`
     at batch 8 x 2048 for 6 steps, uninterrupted and with a checkpoint
     every 2 steps and a failure injected at step 4: the losses from
     step 4 and the final parameters equal (where not, the step's
     nondeterministic ops named and the losses within 5e-3); the
     checkpoint's bytes, a blocking save and a restore timed;
 19. LM serving through `launch.steps.make_prefill_step` /
     `make_decode_step` (random weights from `init_params`, seeded numpy
     prompts): Gemma-7B (full config, 8.54 B parameters) batch 4 x 2,048
     and 64 greedy decode steps; RecurrentGemma-9B at full width, depth
     3, 1 x 4,096 and 32 steps (its 2,048-token rolling buffer wraps);
     MiniCPM-2B (full config) 4 x 2,048 and 16 steps; Command-R-35B at
     full width, depth 4, 2 x 2,048 and 16 steps (LayerNorm);
     Whisper-large-v3 (full config: 32 encoder and 32 decoder layers)
     over 8 x 1,500 seeded frontend embeddings (30 s of audio a row), a
     128-token prompt and 64 steps; Llama-3.2-Vision-11B (full config,
     40 layers, a gated cross-attention block every 5th, its gates set
     to 1) 4 x 2,048 with 4,100 vision embeddings a row, 32 steps;
     DeepSeek-V3 at full width, depth 4 (its 3 dense MLA layers and 1
     MoE layer), and Arctic at full width, depth 2 ('dense_moe'), each 4
     x 2,048 and 32 steps; xLSTM-350M (full config: 21 mLSTM and 3
     sLSTM blocks) 4 x 2,048 and 32 steps (the chunkwise mLSTM and the
     sLSTM scan at prefill, their recurrent forms at decode; the path
     launches no kernel, so the checks against the plain versions are
     skipped and said so, and one layer's state update is timed in the
     decode attention's place). Held at 2e-2 relative (max |a - b| / max
     |b|), block by block in lockstep: each block, an encoder's too,
     with its kernels against its plain version on the same input and
     memory (output and cache tensors), and each decoder block's decode
     at the first and last step against the train forward over the
     prompt and the generated tokens; a MoE block taken apart (its
     mixer and mixer cache; its FFN on the tokens whose experts and kept
     pairs agree; the share of tokens picking another top-k set at most
     1.25 x SDPA's in the kernel's place; the dropped pairs reported; at
     decode its FFN against the forward's run again on the same B
     tokens, at most one of which picks another top-k set); the first
     greedy tokens equal to the plain prefill's. End to end (reported,
     beside PyTorch's SDPA in the kernel's place): the prefill against
     the plain one, each decode step against the train forward, the
     first block where they part, the argmax agreement.
     Prefill ms and tokens/s, decode ms a step and tokens/s, one decode
     step profiled (and a frontend or MoE cell's prefill), one layer's
     decode attention (MLA's absorption form; cross-attention) and the
     float32 head timed, peak
     memory. Then
     `flash_attention_fwd` at the serving cells' prefill shapes (Gemma
     (4, 16 / 16, 2048, 256), MiniCPM (4, 36 / 36, 2048, 64), Command-R
     (2, 64 / 8, 2048, 128), Whisper's decoder (8, 20 / 20, 128, 64),
     causal; non-causal, Sq != Skv, ragged key edges: Whisper's encoder
     (8, 20 / 20, 1,500 x 1,500, 64), its cross-attention (128 x 1,500)
     and Llama-Vision's (4, 32 / 8, 2,048 x 4,100, 128); DeepSeek's MLA
     (4, 128 / 128, 2,048, q and k 192, v 128) and Arctic's (4, 56 / 8,
     2,048, 128), causal) against the plain pair schedule, timed beside
     SDPA;
 20. xLSTM-350M's training and the mLSTM's forms: one mLSTM block at
     full width (d 1,024, 4 heads of 512) in float32 over 4 x 2,048, the
     chunkwise form within 1e-4 of the quadratic form at every position
     and within 1e-3 of the recurrent form stepped token by token
     (outputs and final (C, n, m)); `run_plain` at full depth (0.50 B
     parameters), 4 x 2,048, 2 steps (finite, the first loss within 0.5
     of ln V + 1/2, a random tied head's), then 1 step with
     ``remat="block"``: the same loss and grad norm, a lower peak;
     one mLSTM and one sLSTM block forward and backward at those shapes
     (the step's breakdown); SmolLM-135M (full config) at 4 x 2,048, one
     step under each of ``remat`` "none", "block" and "block_save_flash":
     the same loss and grad norm, `flash_attention_fwd` launched 30, 60
     and 30 times (the recompute; the kept outputs), the peak of each;
 11. checks the launch counts of each driven path, read with the counts
     reset just before it and read just after (phase 3's run without the
     threshold kernel, phases 3 and 14's L2 at D = 9, phases 4-5, phases 6-7,
     phase 9's run, phase 10's run, phases 12-13 armed, phase 12's last
     schedule, phase 15's batched engines, phase 16, phase 17's ranks,
     summed, phase 18's kernels-on drills, phase 18's two trainer runs,
     phase 19's prefills and decode steps, phase 20's xLSTM runs (no
     kernel) and its SmolLM remat steps):
     every kernel the
     path runs launched at least once, every other kernel never
     (`due_dedup` never on the armed paths: an armed engine elects with
     the plain version). Prints one JSON line with every kernel's
     launches (on its main path, and on each path that runs it), its
     error, times and bound.

Every phase asserts; the last line is the run's JSON verdict. Exits
non-zero without printing a result when no CUDA device is present or the
port's sources are missing. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32 peak; the int32 work
# of these kernels is priced at this rate (the data sheet lists no int32
# ALU rate)
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
# one FMUL or FADD a lane a clock: 132 SMs x 128 FP32 lanes x 1.98 GHz
# (H100 SXM boost clock). The L2 form rounds every product and sum on its
# own, so it cannot use the FFMA that ALU_OPS_PER_S counts as two
FP32_ISSUE_PER_S = 132 * 128 * 1.98e9
N_BIG = 1_000_000
N_MID = 100_000
ARMED_BIG_CYCLES = 2000  # the armed 1e6 run's cap: converged or not
SOURCES = {
    "stage_rows": ("src/repro_torch/kernels/csrc/enqueue.cu",
                   "src/repro/kernels/wheel/enqueue.py:52"),
    "threshold_step": ("src/repro_torch/kernels/csrc/threshold_step.cu",
                       "src/repro/kernels/wheel/threshold_step.py:35"),
    "due_dedup": ("src/repro_torch/kernels/csrc/due_dedup.cu",
                  "src/repro/kernels/wheel/due_dedup.py:78"),
    "descent_tail": ("src/repro_torch/kernels/csrc/descent.cu",
                     "src/repro/kernels/wheel/descent.py:85"),
    "threshold_step_mean": ("src/repro_torch/kernels/csrc/threshold_step.cu",
                            "src/repro/kernels/wheel/threshold_step.py:35"),
    "threshold_step_l2": ("src/repro_torch/kernels/csrc/threshold_step.cu",
                          "src/repro/kernels/wheel/threshold_step.py:35"),
    "threshold_step_l2_general": (
        "src/repro_torch/kernels/csrc/threshold_step.cu",
        "src/repro/kernels/wheel/threshold_step.py:35"),
    "majority_step": ("src/repro_torch/kernels/csrc/majority_step.cu",
                      "src/repro/kernels/majority_step/majority_step.py:45"),
    "threshold_gate": ("src/repro_torch/kernels/csrc/threshold_gate.cu",
                       "src/repro/kernels/threshold_gate/threshold_gate.py:36"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru.cu",
                   "src/repro/kernels/rglru/rglru.py:56"),
    "flash_attention_fwd": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:101"),
}
# the kernels each driven path launches (every other kernel must stay at
# 0 there), and the path whose count a kernel's entry reports
PATH_KERNELS = {
    "majority_no_threshold": {"stage_rows", "due_dedup", "descent_tail",
                              "majority_step"},
    "majority": {"stage_rows", "threshold_step", "due_dedup",
                 "descent_tail"},
    "mean_l2": {"stage_rows", "due_dedup", "descent_tail",
                "threshold_step_mean", "threshold_step_l2"},
    "l2_any_dim": {"stage_rows", "due_dedup", "descent_tail",
                   "threshold_step_l2_general"},
    "train_rg9b": {"rglru_scan", "flash_attention_fwd"},
    # armed engines elect with the plain version: due_dedup stays at 0
    "armed": {"stage_rows", "threshold_step", "descent_tail",
              "threshold_step_mean", "threshold_step_l2"},
    "armed_no_threshold": {"stage_rows", "descent_tail", "majority_step"},
    "train_smollm_threshold": {"flash_attention_fwd", "threshold_gate"},
    # phase 15's majority sweep and B = 4 at 1e6; phase 16 (all problems)
    "batched": {"stage_rows", "threshold_step", "due_dedup", "descent_tail"},
    "serve": {"stage_rows", "threshold_step", "due_dedup", "descent_tail",
              "threshold_step_mean", "threshold_step_l2"},
    # phase 17's ranks, summed over every rank of worlds 1, 2 and 4
    "sharded": {"stage_rows", "threshold_step", "due_dedup", "descent_tail",
                "majority_step", "threshold_step_mean", "threshold_step_l2"},
    # phase 18: the elastic drills with kernels; run_plain with resume
    "control": {"stage_rows", "threshold_step", "due_dedup", "descent_tail"},
    "train_smollm_resume": {"flash_attention_fwd"},
    # phase 19: the nine serving cells' prefills and decode steps (the
    # xLSTM cell's launch none)
    "serve_lm": {"flash_attention_fwd", "rglru_scan"},
    # phase 20: xLSTM-350M's run_plain runs (no kernel on their path); the
    # SmolLM-135M steps under each remat
    "train_xlstm": set(),
    "remat": {"flash_attention_fwd"},
}
MAIN_PATH = {"stage_rows": "majority", "threshold_step": "majority",
             "due_dedup": "majority", "descent_tail": "majority",
             "threshold_step_mean": "mean_l2", "threshold_step_l2": "mean_l2",
             "threshold_step_l2_general": "l2_any_dim",
             "majority_step": "majority_no_threshold",
             "rglru_scan": "train_rg9b", "flash_attention_fwd": "train_rg9b",
             "threshold_gate": "train_smollm_threshold"}
# integer operations per unit of work, counted from the CUDA sources
OPS_PER_ROW = {"stage_rows": 1, "threshold_step": 40, "due_dedup": 30,
               "descent_tail": 60,  # descent: per row-step
               "threshold_step_mean": 40, "majority_step": 40}


def l2_ops_per_row(dim: int, ndirs: int, general: bool = False) -> int:
    """Float operations of an L2 form per peer: 7 projections (K, and A
    and K - A per direction) of 2D + 1 operations (D products, D - 1 sums,
    Tf c and the difference) and 7 sign tests per cover direction, plus
    the int32 sums (~10 P). The general form (`general`) rounds the 7
    Tf c products once a row, so a direction costs 7 2D + 7."""
    if general:
        return ndirs * (14 * dim + 7) + 7 + 10 * (dim + 1)
    return ndirs * (7 * (2 * dim + 1) + 7) + 10 * (dim + 1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("phase "):  # each phase's start, in script seconds
        msg = f"{msg} [at {time.perf_counter() - T_START:.1f} s]"
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


def profiled(fn, dev):
    """Run `fn` under the profiler's device trace, after a first run of it
    in the profiler's warm-up step (`device_events`): (device
    microseconds, device events: kernels, copies, memsets)."""
    _, ev = device_events(dev, fn, warmup=fn, cpu=False)
    return (sum(e.self_device_time_total for e in ev),
            sum(e.count for e in ev))


def device_ms(fn, dev, iters: int) -> float:
    """Mean device milliseconds per call: the summed duration of the
    kernels (and copies) the call ran, from the profiler's device trace —
    host launch overhead and host syncs excluded. A session that holds
    fewer device events than `iters` calls launch is refused and profiled
    again (a session may come back empty or drop events): a call launches
    at least its counted kernels (`LAUNCHES` around one call), and one
    with none counted (a plain version) at least the events of a
    one-call session."""
    from repro_torch.kernels.wheel import LAUNCHES

    if dev.type != "cuda":  # CPU rehearsal of the script: wall time
        return time_ms(fn, dev, iters)
    k0 = sum(LAUNCHES.values())
    fn()
    sync(dev)
    per_call = sum(LAUNCHES.values()) - k0
    seen = []
    for _ in range(5):
        if per_call == 0:
            per_call = max(1, profiled(fn, dev)[1])
        us, n_ev = profiled(lambda: [fn() for _ in range(iters)], dev)
        if us > 0 and n_ev >= iters * per_call:
            return us / 1e3 / iters
        seen.append(n_ev)
        log(f"  profile refused: {n_ev} device events for {iters} calls "
            f"of {per_call}")
    raise RuntimeError(f"the profiler recorded {seen} device events in "
                       f"five sessions of {iters} calls, fewer than "
                       f"{iters * per_call}")


def cold_ms(fn, dev, iters: int):
    """Mean device milliseconds of `fn` with the 50 MB L2 evicted before
    each call: a 512 MB read (clean lines, so the call writes back no
    dirty ones; longer on the card than the host takes to enqueue the
    call), then CUDA events around the call alone. None off the card."""
    import torch

    if dev.type != "cuda":
        return None
    junk = torch.ones(1 << 27, device=dev)
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        junk.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(dev)
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(name: str, io_bytes: int, work: int, ops_per_row=None):
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = work * (ops_per_row or OPS_PER_ROW[name]) / ALU_OPS_PER_S
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


def problem_data(name: str, n: int, rng, phase: int):
    """The golden cells' raw data: mean N(-0.6 / +0.6, 0.8); L2 a cloud
    (sd 0.9) around a mean outside (phase 0) / inside (phase 1) the
    tau = 1 ball. Phase 1 flips the global decision."""
    import numpy as np

    if name == "mean":
        return rng.normal(-0.6 if phase == 0 else 0.6, 0.8, size=n)
    c = np.array([0.6, -0.8]) * (1.3 if phase == 0 else 0.45)
    return rng.normal(c, 0.9, size=(n, 2))


def make_problem(name: str, problem, n: int, dev, seed: int, **kw):
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine

    rng = np.random.default_rng(seed)
    ring = Ring.random(n, 32, seed=seed)
    eng = make_engine("torch", ring, problem_data(name, n, rng, 0),
                      seed=seed + 1, device=dev, capacity_per_peer=8,
                      problem=problem, **kw)
    return eng, rng


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


def descent_row_steps(args):
    """(row-steps, steps of the longest row) of the descent loop on these
    inputs (its data-dependent work), counted with the plain loop's own
    rules."""
    import torch
    from repro_torch.engine import protocol as proto
    from repro_torch.kernels.wheel._common import in_segment

    (origin, dest, edge, he, live, entry, pos_i, a_prev, a_self, sseg,
     max_addr, d) = args
    lv, ent, cd, ce, ch = live, entry, dest, edge, he
    steps = longest = 0
    while bool(lv.any()):
        steps += int(lv.sum())
        longest += 1
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
    return steps, longest


def phase_kernels(dev, sizes, iters: int) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.engine.problems import L2Thresh, Majority, MeanMonitor
    from repro_torch.kernels import majority_step as MS
    from repro_torch.kernels import wheel as W
    from repro_torch.kernels.wheel.threshold_step import l2_general_geometry

    rng = np.random.default_rng(2026)
    rows = {}

    def check(name, kernel, plain, args, work, piters, ops_per_row=None,
              tag="", main=True, io=None):
        want = plain(*args)
        got = kernel(*args)
        sync(dev)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        assert err == 0, f"{name}{tag}: kernel differs from its plain version"
        if io is None:
            io = nbytes(*[a for a in args if isinstance(a, torch.Tensor)],
                        *got)
        call = time_ms(lambda: kernel(*args), dev, iters)
        pcall = time_ms(lambda: plain(*args), dev, piters, warmup=1)
        ms = device_ms(lambda: kernel(*args), dev, iters)
        pms = device_ms(lambda: plain(*args), dev, piters)
        b_ms, by = bound(name, io, work, ops_per_row)
        fig = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
               "bound_ms": b_ms, "bound_by": by, "library_ms": None,
               "call_ms": call}
        shapes = rows.setdefault(name, {}).setdefault("shapes", {})
        shapes[tag.strip() or "main"] = fig
        if main:
            rows[name].update(fig)
        log(f"  {name + tag:15s} equal (max_abs_err 0)  device: kernel "
            f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms ({by}); "
            f"per call with launch: kernel {call:.4f} ms, plain {pcall:.4f} "
            f"ms  [{io / 1e6:.1f} MB moved]")

    # stage_rows: the staged block, lanes * 4 * window_l rows, of width 9
    # (L2 with D = 2, DELIVER_T in column 8) and of width 8 (majority and
    # mean, column 7; the row the JSON line reports)
    m = sizes["staged"]
    for roww in (9, 8):
        vals = torch.from_numpy(rng.integers(
            0, 2**32, (m, roww), dtype=np.uint64).astype(np.int64))
        mask = torch.from_numpy(rng.random(m) < 0.6)
        args = (vals.to(dev), torch.from_numpy(rng.random(m) < 0.15).to(dev),
                (torch.cumsum(mask.long(), 0) - 1).to(dev),
                torch.from_numpy(
                    (rng.permutation(10) + 1).astype(np.int32))[None].to(dev),
                torch.tensor([-5], dtype=torch.int32, device=dev),
                roww - 1)  # t = 2^32 - 5: the stamp wraps at 32 bits
        check("stage_rows", W.stage_rows, W.stage_rows_reference, args,
              m, max(1, iters // 4), tag=f" w{roww}", main=roww == 8)
        del vals, args

    # threshold_step: one row per window row
    ww = sizes["window"]
    mk = lambda shape, lo, hi: torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int32)).to(dev)
    prob = Majority()
    args = (mk((ww, 3, 2), 0, 60), mk((ww, 3, 2), 0, 60), mk((ww, 1), 0, 2))
    check("threshold_step", lambda *a: W.threshold_step(prob, *a),
          lambda *a: W.threshold_step_reference(prob, *a), args, ww,
          max(1, iters // 4))

    # the mean and L2 forms: per cycle on the window (WW rows, the row
    # the JSON line reports) and at every event react (pad rows); a
    # sixteenth of the mean rows sit at the int32 edges (sums wrap), a
    # quarter of the L2 rows tie in the argmax
    pad = sizes["pad"]
    edges = np.array([-2**31, 2**31 - 1, -1, 0], np.int32)

    def ints(lo, hi, shape, edge_rows=0):
        a = rng.integers(lo, hi, shape).astype(np.int32)
        a[:edge_rows] = rng.choice(edges, (edge_rows,) + tuple(shape[1:]))
        return a

    mean = MeanMonitor(tau=0.3)
    l2 = L2Thresh(tau=1.0, dim=2, ndirs=16)
    l2_ops = l2_ops_per_row(2, 16)
    for n_rows, tag in ((pad, " @pad"), (ww, " @WW")):  # WW: the main row
        e = n_rows // 16
        args = tuple(torch.from_numpy(a).to(dev) for a in (
            ints(-40_000, 40_001, (n_rows, 3, 2), e),
            ints(-40_000, 40_001, (n_rows, 3, 2), e),
            ints(-300, 301, (n_rows, 1), e)))
        check("threshold_step_mean", lambda *a: W.threshold_step(mean, *a),
              lambda *a: W.threshold_step_reference(mean, *a), args, n_rows,
              max(1, iters // 4), tag=tag, main=n_rows == ww)
        ip = ints(-768, 769, (n_rows, 3, 3))
        op = ints(-768, 769, (n_rows, 3, 3))
        ip[..., 2] = rng.integers(0, 4, (n_rows, 3))
        op[..., 2] = rng.integers(0, 4, (n_rows, 3))
        x = ints(-512, 513, (n_rows, 2))
        q = n_rows // 4
        ip[:q, :, :2] = 0
        x[:q] = 0  # zero vector sums: every half-space ties
        args = tuple(torch.from_numpy(a).to(dev) for a in (ip, op, x))
        check("threshold_step_l2", lambda *a: W.threshold_step(l2, *a),
              lambda *a: W.threshold_step_reference(l2, *a), args, n_rows,
              max(1, iters // 4), ops_per_row=l2_ops, tag=tag,
              main=n_rows == ww)

    # the general L2 kernel (any D, any cover): D = 9 with M = 18 at the
    # event react's pad rows (the row the JSON line reports), and a
    # 16,384-float cover (D = 16, M = 1024) at the window's rows — past
    # the shared-memory form's 12,288
    for dim, ndirs, n_rows, tag in ((9, 18, pad, " D9 M18 @pad"),
                                    (16, 1024, ww, " D16 M1024 @WW")):
        prob = L2Thresh(tau=1.0, dim=dim, ndirs=ndirs)
        ip = ints(-768, 769, (n_rows, 3, dim + 1))
        op = ints(-768, 769, (n_rows, 3, dim + 1))
        ip[..., dim] = rng.integers(0, 4, (n_rows, 3))
        op[..., dim] = rng.integers(0, 4, (n_rows, 3))
        x = ints(-512, 513, (n_rows, dim))
        q = n_rows // 4
        ip[:q, :, :dim] = 0
        x[:q] = 0
        args = tuple(torch.from_numpy(a).to(dev) for a in (ip, op, x))
        check("threshold_step_l2_general",
              lambda *a, p=prob: W.threshold_step(p, *a),
              lambda *a, p=prob: W.threshold_step_reference(p, *a), args,
              n_rows, max(1, iters // 10),
              ops_per_row=l2_ops_per_row(dim, ndirs, general=True),
              tag=tag, main=dim == 9)
        fig = rows["threshold_step_l2_general"]["shapes"][tag.strip()]
        fig["geometry"] = l2_general_geometry(dim, ndirs)
        if fig["bound_by"] == "operations":
            # the floor of unfused float work: every op its own issue
            fig["issue_bound_ms"] = (
                n_rows * l2_ops_per_row(dim, ndirs, general=True)
                / FP32_ISSUE_PER_S * 1e3)
            log(f"  {'':15s} unfused issue-rate floor "
                f"{fig['issue_bound_ms']:.4f} ms (the table's operations "
                f"bound {fig['bound_ms']:.4f} ms counts an FFMA as two)")
        log(f"  {'':15s} launch shape {json.dumps(fig['geometry'])}")
        del args, ip, op, x

    # majority_step: the event react's (N, 3) planes at pad rows
    planes = [ints(0, 60, (pad, 3), pad // 16) for _ in range(4)]
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        *planes, rng.integers(0, 2, pad).astype(np.int32)))
    check("majority_step", MS.majority_step, MS.majority_step_reference,
          args, pad, max(1, iters // 4))

    # due_dedup: uniform links, many rows sharing a link, and every
    # direction of ww / 8 peers hit (a best and an abest on most); then the
    # scratch again on each window in turn, so every call meets the cells
    # of another call's epoch
    nl = sizes["links"]
    shared = min(30_000, nl // 24)
    windows = {}
    for tag, links, alerts in (("uniform", nl // 3, 0.05),
                               ("shared", shared, 0.05),
                               ("all_dirs", ww // 8, 0.3)):
        if tag == "all_dirs":
            flat = np.concatenate([rng.permutation(3 * links), rng.integers(
                0, 3 * links, ww - 3 * links)])
        else:
            flat = rng.integers(0, links, ww) * 3 + rng.integers(0, 3, ww)
        acc = rng.random(ww) < 0.6
        alert = rng.random(ww) < alerts
        args = (torch.from_numpy(flat).to(dev),
                torch.from_numpy(acc & ~alert).to(dev),
                torch.from_numpy(acc & alert).to(dev), mk(ww, 0, 50),
                mk(ww, 0, 50), nl)
        windows[tag] = args
        if tag == "uniform":
            check("due_dedup", W.due_dedup, W.due_dedup_reference, args,
                  ww, max(1, iters // 4))
        else:
            got, want = W.due_dedup(*args), W.due_dedup_reference(*args)
            sync(dev)
            assert max_abs_err(got, want) == 0, f"due_dedup ({tag})"
            log(f"  {'due_dedup':15s} equal ({tag}: ~{ww // links} rows "
                f"per {'link' if tag == 'shared' else 'peer'})")
    for tag in ("all_dirs", "uniform", "shared", "all_dirs"):
        got = W.due_dedup(*windows[tag])
        want = W.due_dedup_reference(*windows[tag])
        sync(dev)
        assert max_abs_err(got, want) == 0, f"due_dedup ({tag}, again)"
    log(f"  {'due_dedup':15s} equal on 4 more calls, one scratch, "
        f"windows in turn")
    del windows

    # descent_tail: the narrow-tail batch of a real cycle. Its bytes are
    # what the rows need: a live row reads its 52 input bytes, a row that
    # is not live only live, dest, edge and has_edge (18); each writes 19
    dargs, eng = sizes["descent"]
    steps, longest = descent_row_steps(dargs)
    m, live = dargs[0].shape[0], int(dargs[4].sum())
    check("descent_tail", W.descent_tail, W.descent_reference, dargs,
          steps, max(1, iters // 8), io=live * 71 + (m - live) * 37)
    # the same rows with none live (no row loop, no second read), and the
    # card's launch floor: the device time of a one-element fill, both
    # through the same profiler path
    dead = list(dargs)
    dead[4] = torch.zeros_like(dargs[4])
    check("descent_tail", W.descent_tail, W.descent_reference, dead, 0,
          max(1, iters // 8), tag=" no live", main=False, io=m * 37)
    floor = device_ms(lambda: torch.zeros(1, device=dev), dev, iters)
    rows["descent_tail"].update(launch_floor_ms=floor,
                                longest_row_steps=longest)
    log(f"  descent batch: {m} rows, {live} live, {steps} row-steps, the "
        f"longest row {longest} steps; launch floor (torch.zeros(1) device "
        f"time) {floor:.4f} ms")
    del eng
    return rows


def phase_l2_cuda_tests() -> str:
    """The L2 forms' CUDA tests (tests/test_torch_cuda.py: the general
    kernel's tiling cases among them), in a pytest process of their own on
    this card; asserts they all pass. Returns pytest's summary line."""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         os.path.join(HERE, "tests", "test_torch_cuda.py"), "-k",
         "threshold_step_l2_kernel"], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=900)
    tail = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    assert res.returncode == 0 and "passed" in tail and "skipped" not in \
        tail, f"the L2 CUDA tests failed:\n{res.stdout[-4000:]}"
    log(f"  the L2 kernels' CUDA tests on this card: {tail}")
    return tail


# -- phase 1: what the flash kernels were compiled to -------------------------

FLASH_FN = re.compile(r"flash_fwd_(bf16|f32)_kernelILi(\d+)ELi(\d+)EE")


def flash_name(mt) -> str:
    """"bf16 D256" for a square instantiation, "bf16 D192/128" else."""
    dk, dv = mt.group(2), mt.group(3)
    return f"{mt.group(1)} D{dk}" + ("" if dk == dv else f"/{dv}")


def flash_sass_report(out_dir) -> dict:
    """Per flash instantiation ("bf16 D256", "bf16 D192/128", ...): its
    HGMMA (wgmma) instructions in `cuobjdump -sass` of the built library,
    and the registers and spill bytes ptxas reported. Asserts that every
    bf16 instantiation runs on the tensor cores (HGMMA > 0), that the
    float32 ones do not (0), and that bf16 D = 256 and D = 192/128 spill
    nothing. Every (key width, value width) pair the wrapper accepts
    (`HEAD_PAIRS`) must have been compiled."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import HEAD_PAIRS

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", os.path.join(out_dir, "libflash_attention.so")],
        capture_output=True, text=True, timeout=300, check=True).stdout
    rep = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            mt = FLASH_FN.search(line)
            name = flash_name(mt) if mt else None
            if name:
                rep[name] = {"hgmma": 0}
        elif name and "HGMMA" in line:
            rep[name]["hgmma"] += 1
    name = None
    for line in _build.BUILD_INFO.get("ptxas", {}).get(
            "flash_attention", "").splitlines():
        mt = FLASH_FN.search(line)
        if "Compiling entry function" in line and mt:
            name = flash_name(mt)
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            rep.setdefault(name, {})["spill_bytes"] = int(st) + int(ld)
        elif name and "Used" in line:
            rep[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    for dk, dv in HEAD_PAIRS:
        tail = f"D{dk}" + ("" if dk == dv else f"/{dv}")
        assert rep[f"bf16 {tail}"]["hgmma"] > 0, f"bf16 {tail}: no HGMMA"
        assert rep[f"f32 {tail}"]["hgmma"] == 0, f"f32 {tail}: HGMMA"
    for tail in ("D256", "D192/128"):
        if "spill_bytes" in rep.get(f"bf16 {tail}", {}):  # report kept
            assert rep[f"bf16 {tail}"]["spill_bytes"] == 0, \
                f"bf16 {tail} spills"
    return rep


def ptxas_of(source: str, fn: str) -> dict:
    """Registers, static shared bytes and spill bytes that ptxas reported
    for the entry function of ``csrc/<source>.cu`` whose name holds `fn`
    (empty where the build kept no report)."""
    from repro_torch.kernels import _build

    rep, entry, props = {}, False, ""
    for line in _build.BUILD_INFO.get("ptxas", {}).get(source,
                                                       "").splitlines():
        if "Compiling entry function" in line:
            entry = fn in line
        elif "Function properties for" in line:
            props = line
        elif fn in props and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            rep["spill_bytes"] = int(st) + int(ld)
        elif entry and "Used" in line:
            rep["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rep["static_smem_bytes"] = int(smem.group(1)) if smem else 0
            entry = False
    return rep


# -- phase 3: the engine with kernels vs with plain versions ---------------

def assert_same_state(a, b, where: str) -> None:
    import numpy as np
    from repro_torch.engine.convert import state_to_numpy

    sa, sb = state_to_numpy(a._st), state_to_numpy(b._st)
    for f in sa:
        assert np.array_equal(sa[f], sb[f]), f"state field {f} differs {where}"


CHURN_N = 4096  # the churn cells' ring size (phases 3 and 17)
NO_THRESHOLD = ("dedup", "enqueue", "descent")


def state_digest(st: dict) -> dict:
    """sha256 of each state field (dtype, shape and bytes)."""
    return {k: hashlib.sha256(f"{v.dtype}{v.shape}".encode()
                              + v.tobytes()).hexdigest()
            for k, v in st.items()}


def snapshot(eng) -> dict:
    """The digest of the engine's whole state (a sharded engine's blocks
    gathered, on every rank)."""
    return state_digest(eng.global_state())


def churn_cell(cell: str, dev, plain: bool = False, **mesh):
    """The engine of churn cell `cell` ("majority", "mean" (tau 0.3),
    "l2" (tau 1, D 2) or "majority_no_threshold") at n = CHURN_N, with its
    kernels ("majority_no_threshold": all but the threshold kernel) or,
    `plain`, every plain version; `mesh` goes to `make_engine`. Returns
    (the engine, the data its flip sets)."""
    import numpy as np
    from repro_torch.engine import L2Thresh, MeanMonitor

    n, rng = CHURN_N, np.random.default_rng(5)
    if cell in ("mean", "l2"):
        prob = MeanMonitor(tau=0.3) if cell == "mean" else L2Thresh(tau=1.0,
                                                                   dim=2)
        eng = make_problem(cell, prob, n, dev, seed=12,
                           wheel_kernels="none" if plain else "auto",
                           **mesh)[0]
        return eng, problem_data(cell, n, rng, 1)
    wk = "none" if plain else (NO_THRESHOLD if cell == "majority_no_threshold"
                               else "auto")
    eng = make(n, dev, seed=12, mu=0.45, wheel_kernels=wk, **mesh)[0]
    return eng, votes_at(n, 0.55, rng)


def churn_script(engs, new, check) -> None:
    """The churn cells' script on `engs` in lockstep: 60 cycles, a data
    flip to `new` over every peer, then 8 churn events 20 cycles apart;
    `check(where)` after the 60 cycles, after the flip, after each churn
    event and after the 20 cycles that follow it."""
    import numpy as np
    from repro_torch.core.churn import random_schedule

    a = engs[0]
    for e in engs:
        e.step(60)
    check("after 60 cycles")
    for e in engs:
        e.apply_coalesced(np.arange(new.shape[0]), new)
    check("after the data flip")
    sched = random_schedule(a.ring, 8, seed=13, spacing=20)
    for i, (op, gap, snap) in enumerate(zip(sched.ops, sched.gaps,
                                             sched.snaps)):
        for e in engs:
            if op[0] == "join":
                e.join(op[1], vote=op[2])
            else:
                e.leave(op[1])
        assert np.array_equal(np.asarray(a.ring.addrs), snap[0].addrs)
        check(f"after churn event {i} ({op[0]})")
        for e in engs:
            e.step(int(gap))
        check(f"{gap} cycles after event {i}")
    for e in engs:
        assert e.dropped == 0
        e.check_conservation()


def phase_parity_churn(dev, cell: str, label: str) -> tuple:
    """Kernels-on vs plain engines of churn cell `cell` (`churn_cell`) in
    lockstep through `churn_script`, full state compared at each of its
    checks. Returns the kernels-on engine's launch counts (reset just
    before it is built; the plain engine launches no kernel) and its
    state digest at each check: the trajectory phase 17's sharded engines
    must reproduce."""
    from repro_torch.kernels.wheel import launch_counts, reset_launches

    reset_launches()
    (a, new), (b, _) = churn_cell(cell, dev), churn_cell(cell, dev, True)
    digests = []

    def check(where):
        assert_same_state(a, b, f"({label}) {where}")
        digests.append(snapshot(a))

    churn_script((a, b), new, check)
    sync(dev)
    counts = launch_counts()
    log(f"  n={CHURN_N} {label}: kernels-on and plain engines equal in full "
        f"state after 60 cycles, after a data flip, and after each of 8 "
        f"churn events and the 20 cycles after it (t={a.t}, n={a.n}, "
        f"messages={a.messages_sent}, deferred={a.deferred})")
    return counts, digests


def phase_parity_l2_any_dim(dev, n: int, dim: int) -> None:
    """An L2 engine at data width `dim` (the general kernel past D = 8)
    with its kernels vs with their plain versions, through 40 cycles, a
    full-width data flip and 40 more: full state equal after each."""
    import numpy as np
    from repro_torch.engine import L2Thresh, make_engine
    from repro_torch.core.dht import Ring

    rng = np.random.default_rng(31)
    ring = Ring.random(n, 32, seed=31)
    c = np.zeros(dim)
    c[:2] = 0.6, -0.8
    data0 = rng.normal(1.3 * c, 0.9, (n, dim))
    data1 = rng.normal(0.45 * c, 0.9, (n, dim))
    prob = L2Thresh(tau=1.0, dim=dim)
    a, b = (make_engine("torch", ring, data0, seed=32, device=dev,
                        capacity_per_peer=8, problem=prob, wheel_kernels=wk)
            for wk in ("auto", "none"))
    for stage in ("40 cycles", "the data flip", "40 more cycles"):
        for e in (a, b):
            if stage == "the data flip":
                e.apply_coalesced(np.arange(n), data1)
            else:
                e.step(40)
        assert_same_state(a, b, f"(L2 D={dim}) after {stage}")
    assert a.dropped == 0
    a.check_conservation()
    log(f"  L2 D={dim} n={n}: kernels-on and plain engines equal in full "
        f"state after 40 cycles, a data flip and 40 more (t={a.t}, "
        f"messages={a.messages_sent})")


# -- phases 12 and 13: the fault plane --------------------------------------

# tests/_diff_harness.py's FAULT_GRID: (problem, seed, mode)
FAULT_GRID = (("majority", 404, "crash"), ("mean", 505, "crash"),
              ("majority", 606, "drop"), ("l2", 707, "drop"))


def fault_schedule(problem_name: str, seed: int, faults: str) -> dict:
    """The differential harness's seeded schedule for (problem, seed,
    mode), drawn here the same way (the same generator, in the same
    order): a ring of 48-96 peers, its data, and 3-6 events of steps,
    data changes, joins, leaves and settles; "crash" adds a silent crash
    and the wait for its eviction, "drop" arms message loss and delay
    with a probe-only detector. The mesh resizes it draws do nothing on
    one card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(rng.integers(48, 97))

    def raw(k):
        if problem_name == "majority":
            return rng.integers(0, 2, size=k).astype(np.int64)
        if problem_name == "mean":
            off = float(rng.choice([-0.6, 0.6]))
            return rng.normal(off, 0.8, size=k)
        c = rng.normal(size=2)
        c *= float(rng.choice([0.2, 1.8])) / max(np.linalg.norm(c), 1e-9)
        return rng.normal(c, 0.25, size=(k, 2))

    from repro_torch.core.dht import Ring

    data = raw(n)
    ring_seed = int(rng.integers(0, 2**31))
    occupied = set(int(a) for a in Ring.random(n, 32, seed=ring_seed).addrs)
    n_cur, events = n, []
    n_events = int(rng.integers(3, 7))
    kinds = ["step", "set", "join", "leave", "settle", "resize"]
    fcfg = {"p_drop": 0.1 if faults == "drop" else 0.0,
            "p_delay": 0.05 if faults == "drop" else 0.0,
            "suspect_after": 25,
            "evict_after": 150 if faults == "crash" else 0,
            "seed": seed + 13}
    crash_at = int(rng.integers(1, n_events)) if faults == "crash" else -1
    for ei in range(n_events):
        if ei == crash_at:
            events.append(("crash", int(rng.integers(0, n_cur))))
            events.append(("resize", 2))
            events.append(("step", fcfg["evict_after"]
                           + 2 * fcfg["suspect_after"] + 64))
            n_cur -= 1
        kind = str(rng.choice(kinds))
        if kind == "step":
            events.append(("step", int(rng.integers(1, 41))))
        elif kind == "resize":
            events.append(("resize", int(rng.choice([1, 2, 4, 8]))))
        elif kind == "set":
            k = int(rng.integers(1, max(2, n_cur // 4)))
            idx = np.sort(rng.choice(n_cur, size=k, replace=False))
            events.append(("set", idx.astype(np.int64), raw(k)))
        elif kind == "join":
            while True:
                addr = int(rng.integers(1, 1 << 16))
                if addr not in occupied:
                    break
            occupied.add(addr)
            events.append(("join", addr, raw(1)[0]))
            n_cur += 1
        elif kind == "leave":
            if n_cur <= 8:
                continue
            events.append(("leave", int(rng.integers(0, n_cur))))
            n_cur -= 1
        else:
            events.append(("settle",))
    return {"problem": problem_name, "n": n, "ring_seed": ring_seed,
            "eng_seed": seed + 7, "data": data, "events": events,
            "faults": fcfg}


def fault_engine(sched: dict, dev, wheel_kernels, **mesh):
    """The armed engine of fault schedule `sched` (`fault_schedule`) with
    `wheel_kernels`; `mesh` goes to `make_engine`."""
    from repro_torch.core.dht import Ring
    from repro_torch.engine import FaultConfig, get_problem, make_engine

    name = sched["problem"]
    kw = {"mean": dict(tau=0.0), "l2": dict(tau=1.0, dim=2)}.get(name, {})
    return make_engine("torch", Ring.random(sched["n"], 32,
                                            seed=sched["ring_seed"]),
                       sched["data"], seed=sched["eng_seed"], device=dev,
                       problem=get_problem(name, **kw),
                       faults=FaultConfig(**sched["faults"]),
                       wheel_kernels=wheel_kernels, **mesh)


def fault_script(engs, sched: dict, check) -> None:
    """The events of fault schedule `sched` on `engs` in lockstep (a mesh
    resize does nothing on one engine), then the run to convergence;
    `check(where)` after every event and at convergence."""
    problem = engs[0].problem
    converge = lambda e: e.run_until_converged(
        problem.global_output(e.data()), max_cycles=40_000)
    for i, ev in enumerate(sched["events"]):
        for e in engs:
            if ev[0] == "step":
                e.step(ev[1])
            elif ev[0] == "set":
                e.set_votes(ev[1], ev[2])
            elif ev[0] == "join":
                e.join(ev[1], vote=ev[2])
            elif ev[0] == "leave":
                e.leave(ev[1])
            elif ev[0] == "crash":
                e.crash(ev[1])
            elif ev[0] == "settle":
                assert converge(e)["converged"] == 1.0, (problem.name, ev)
        check(f"after event {i} {ev[0]}")
    for e in engs:
        assert converge(e)["converged"] == 1.0, problem.name
    check("at convergence")


def fault_digest(eng) -> tuple:
    """An armed engine's state digest, eviction timeline and loss tally."""
    return snapshot(eng), list(eng.evictions), eng.lost_to_fault


def phase_fault_parity(dev, sched: dict, wheel_kernels) -> list:
    """One fault schedule on two armed engines in lockstep, event by
    event (`fault_script`): `wheel_kernels` vs every plain version. Full
    state, the eviction timeline and the loss tally equal after every
    event and at convergence. Returns the `wheel_kernels` engine's
    `fault_digest` at each of those checks."""
    a, b = (fault_engine(sched, dev, wk) for wk in (wheel_kernels, "none"))
    digests = []

    def check(where):
        where = f"({sched['problem']}) {where}"
        assert_same_state(a, b, where)
        assert a.evictions == b.evictions, where
        assert a.lost_to_fault == b.lost_to_fault, where
        a.check_conservation()
        digests.append(fault_digest(a))

    fault_script((a, b), sched, check)
    assert a.dropped == 0 and a.lost_to_fault > 0
    log(f"  {sched['problem']} seed {sched['eng_seed'] - 7} ({'crash' if sched['faults']['evict_after'] else 'drop'}"
        f", kernels {wheel_kernels}): equal in full state after each of "
        f"{len(sched['events'])} events and at convergence (t={a.t}, "
        f"n={a.n}, evictions {a.evictions}, lost_to_fault "
        f"{a.lost_to_fault})")
    return digests


class CycleKernelCheck:
    """Holds an engine's wheel-kernel calls against their plain versions
    at the sizes its cycle gives them: an armed engine's window is as wide
    as the due slot's alerts and probes, a batched engine's holds every
    trial's lanes. Installed on a `TorchEngine`, it wraps the calls the
    cycle makes (`descent_tail`, then `due_dedup` where `keys` names it,
    `threshold_step`, `stage_rows`); while `on`, a cycle whose descent
    batch has at least `grow` times the rows of the widest checked so far
    is checked: each call's inputs are cloned on the card, the kernel
    runs as the engine runs it (its one counted launch), and the plain
    version on the clones must give the same result exactly. The host
    time spent cloning and checking (between syncs) is kept in `seconds`
    so that a rate can leave it out."""

    NAMES = {"_descent": "descent_tail", "_dedup": "due_dedup",
             "_thresh": "threshold_step", "_stage": "stage_rows"}

    def __init__(self, eng, dev, grow: float = 1.5,
                 keys=("_descent", "_thresh", "_stage")):
        from repro_torch.kernels import wheel as W

        self.eng, self.dev, self.grow, self.keys = eng, dev, grow, keys
        self.on, self.widest, self.widest_seen = False, 0, 0
        self.cur, self.checked, self.seconds = None, [], 0.0
        plain = {"_descent": W.descent_reference,
                 "_dedup": W.due_dedup_reference,
                 "_thresh": W.threshold_step_reference,
                 "_stage": W.stage_rows_reference}
        self.real = {k: getattr(eng, k) for k in keys}
        for k in keys:
            setattr(eng, k, self._wrap(k, self.real[k], plain[k]))

    def remove(self) -> None:
        for k, fn in self.real.items():
            setattr(self.eng, k, fn)

    def complete(self) -> bool:
        """Every checked cycle checked each wrapped call."""
        want = {self.NAMES[k] for k in self.keys}
        return bool(self.checked) and all(want <= set(c)
                                          for c in self.checked)

    def restart(self) -> None:
        """Check the next cycle, whatever its width, and grow from it."""
        self.on, self.widest = True, 0

    def _held(self, fn):
        sync(self.dev)
        t0 = time.perf_counter()
        out = fn()
        sync(self.dev)
        self.seconds += time.perf_counter() - t0
        return out

    def _wrap(self, key, kern, plain):
        import torch

        name = self.NAMES[key]

        def call(*args):
            if key == "_descent":
                rows = int(args[0].shape[0])
                self.widest_seen = max(self.widest_seen, rows)
                self.cur = None
                if self.on and rows >= self.grow * self.widest:
                    self.widest = rows
                    tb = self.eng._tb  # each trial's t
                    self.cur = {"t": (int(tb[0]) if tb.min() == tb.max()
                                      else f"{tb.min()}..{tb.max()}")}
                    self.checked.append(self.cur)
            if self.cur is None:
                return kern(*args)
            clones = self._held(lambda: [
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args])
            got = kern(*args)

            def hold():
                want = plain(*clones)
                g = got if isinstance(got, tuple) else (got,)
                w = want if isinstance(want, tuple) else (want,)
                return max_abs_err(g, w)

            err = self._held(hold)
            assert err == 0, (f"{name} differs from its plain version on "
                              f"the armed cycle t={self.cur['t']}")
            rows = int(args[1 if key == "_thresh" else 0].shape[0])
            self.cur[name] = rows
            if key == "_descent":
                self.cur["descent_live"] = self._held(
                    lambda: int(args[4].sum()))
            del clones
            return got

        return call


def phase_armed_big(dev, n: int, max_cycles: int, p2_rows: dict) -> tuple:
    """Majority at n peers armed with the harness's drop setting (probe-
    only detector): the init storm, then a run toward the truth of at
    most `max_cycles` cycles (converged or not: the figures say which),
    then 30 cycles more. In both runs `CycleKernelCheck` holds the three
    wheel kernels of the armed cycle against their plain versions on the
    cycles of a growing window (the first of each run, then each 1.5
    times wider than the widest checked); the rate leaves the checks'
    time out. `p2_rows` are phase 2's rows, printed beside these.
    Returns the engine and its figures."""
    import torch
    from repro_torch.engine import FaultConfig

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    eng, votes, _ = make(n, dev, seed=5, mu=0.45, faults=FaultConfig(
        p_drop=0.1, p_delay=0.05, suspect_after=25, evict_after=0, seed=9))
    sync(dev)
    t_init = time.perf_counter() - t0
    truth = int(2 * votes.sum() >= n)
    chk = CycleKernelCheck(eng, dev)
    chk.restart()
    t0 = time.perf_counter()
    res = eng.run_until_converged(truth, max_cycles=max_cycles)
    sync(dev)
    dt = time.perf_counter() - t0 - chk.seconds
    t_run, n_run = eng.t, len(chk.checked)
    if res["converged"]:
        assert (eng.outputs() == truth).all()
    chk.restart()
    eng.step(30)
    sync(dev)
    chk.remove()
    assert n_run >= 1 and len(chk.checked) > n_run and chk.complete()
    log(f"  armed kernels vs plain versions, exact on {len(chk.checked)} "
        f"cycles ({n_run} in the run, the first and each 1.5x wider; the "
        f"rest in 30 cycles after it): rows per call (cycle: descent_tail "
        f"[live] / threshold_step / stage_rows) "
        + "; ".join(f"t={c['t']}: {c['descent_tail']} [{c['descent_live']}]"
                    f" / {c['threshold_step']} / {c['stage_rows']}"
                    for c in chk.checked)
        + f"; widest descent batch of any cycle {chk.widest_seen}; phase 2 "
        f"(disarmed): {p2_rows['descent_tail']} / "
        f"{p2_rows['threshold_step']} / {p2_rows['stage_rows']}; "
        f"{chk.seconds:.2f} s of checking left out of the rate")
    cons = eng.check_conservation()
    assert eng.dropped == 0, "messages dropped (armed, n=1e6)"
    assert cons["lost_to_fault"] > 0, "no row lost under p_drop = 0.1"
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else 0.0)
    stats = {"init_s": t_init, "cycles": t_run,
             "converged": bool(res["converged"]),
             "cycles_per_s": t_run / dt,
             "lost_to_fault": cons["lost_to_fault"],
             "kernel_checks": chk.checked,
             "widest_descent_rows": chk.widest_seen,
             "peak_gb": peak, "awheel_gb": nbytes(eng._st.awheel) / 1e9,
             "full_window_rows": eng.lanes * eng.window_l}
    log(f"  armed n={n}: init storm {t_init:.2f} s (pad {eng.pad}, alert "
        f"side-wheel {stats['awheel_gb']:.2f} GB, full window "
        f"{stats['full_window_rows']} rows); "
        f"{'converged to ' + str(truth) + ' in' if res['converged'] else 'not converged after'}"
        f" {t_run} cycles at {t_run / dt:.2f} cycles/s; lost_to_fault "
        f"{cons['lost_to_fault']}, dropped 0, conservation holds; peak "
        f"{peak:.1f} GB (the checks' clones included)")
    return eng, stats


def phase_armed_crash(dev, n: int, seed: int, victims, exact: bool,
                      bridge: bool = False) -> dict:
    """Majority at n peers armed with the crash detector (suspect 25,
    evict 150): converge, crash the `victims` rows, step in 25-cycle
    dispatches until the detector has evicted them all, converge again;
    every survivor must output the truth. With `exact`, nothing but the
    crashed addresses may go; without, the live peers the detector
    evicted as well are counted (the reference's detector convicts a
    live peer on some schedules). With `bridge`, an
    `EngineSuspicionBridge` rides the detector, synced after every
    dispatch from the crash on: it must suspect each crashed peer before
    its eviction, and its planned rejoins must be the engine's
    evictions, in order, each on the restart budget."""
    import numpy as np
    from repro_torch.engine import FaultConfig
    from repro_torch.runtime.fault_tolerance import (EngineSuspicionBridge,
                                                     HeartbeatMonitor,
                                                     RestartPolicy)

    eng, votes, _ = make(n, dev, seed=seed, mu=0.45, faults=FaultConfig(
        suspect_after=25, evict_after=150))
    sweep, sweeps = eng._fault_sweep, []

    def timed():
        t0 = time.perf_counter()
        sweep()
        sweeps.append(time.perf_counter() - t0)

    eng._fault_sweep = timed
    res = eng.run_until_converged(int(2 * votes.sum() >= n))
    assert res["converged"] == 1.0
    gone = {int(eng.ring.addrs[i]) for i in victims}
    for i in victims:
        eng.crash(i)
    t_crash, sweeps[:] = eng.t, []
    evicted = lambda: {a for _, a in eng.evictions}
    # the agent's view of the same detector: heartbeats on the cycle
    # clock, one restart planned per eviction
    agent = EngineSuspicionBridge(
        monitor=HeartbeatMonitor(timeout_s=60.0),
        policy=RestartPolicy(max_restarts=len(victims) + 8))
    plans, suspected, bridge_s = [], set(), 0.0
    if bridge:
        plans = agent.sync(eng)
    sync(dev)
    t0 = time.perf_counter()
    while not gone <= evicted() and eng.t - t_crash < 20 * 256:
        eng.step(25)
        if bridge:
            tb = time.perf_counter()
            plans += agent.sync(eng)
            suspected |= set(agent.suspects(eng))
            bridge_s += time.perf_counter() - tb
    sync(dev)
    dt = time.perf_counter() - t0 - bridge_s
    if bridge:
        assert [a for a, _ in plans] == [a for _, a in eng.evictions], (
            "the bridge's planned rejoins differ from the evictions")
        assert all(d is not None for _, d in plans)
        assert gone <= suspected, "a crashed peer was evicted unsuspected"
    live_evicted = sorted(evicted() - gone)
    assert gone <= evicted(), "a crashed peer was not evicted"
    assert not live_evicted or not exact, f"live peers evicted: {live_evicted}"
    assert not eng.dead_mask().any()
    last = eng.evictions[-1][0] - t_crash
    truth = int(2 * eng.votes().sum() >= eng.n)
    res = eng.run_until_converged(truth)
    assert res["converged"] == 1.0 and (eng.outputs() == truth).all()
    cons = eng.check_conservation()
    assert eng.dropped == 0 and cons["lost_to_fault"] > 0
    out = {"seed": seed, "crashes": len(victims),
           "cycles_to_last_eviction": last,
           "live_evicted": [(c - t_crash, a) for c, a in eng.evictions
                            if a in live_evicted],
           "eviction_cycles": [c - t_crash for c, _ in eng.evictions],
           "sweep_ms_mean": 1e3 * float(np.mean(sweeps)),
           "sweep_ms_max": 1e3 * float(np.max(sweeps)), "sweeps": len(sweeps),
           "cycles_per_s": (eng.evictions[-1][0] - t_crash) / dt,
           "lost_to_fault": cons["lost_to_fault"],
           "bridge_plans": len(plans), "bridge_ms_total": bridge_s * 1e3}
    log(f"  armed n={n} seed {seed}: {len(victims)} crashes at spread "
        f"addresses, all evicted by {last} cycles after the crash "
        f"({out['eviction_cycles']}); live peers evicted as well: "
        f"{out['live_evicted'] or 'none'}; {len(sweeps)} sweeps, host "
        f"{out['sweep_ms_mean']:.1f} ms mean, {out['sweep_ms_max']:.1f} max"
        f"; then converged to {truth} at t={eng.t} on the {eng.n} survivors"
        f", dropped 0, lost_to_fault {cons['lost_to_fault']}, conservation "
        f"holds" + (f"; the suspicion bridge (timeout 60 cycles) suspected "
                    f"every crashed peer before its eviction and planned "
                    f"{len(plans)} rejoins, the evictions in order "
                    f"({bridge_s * 1e3:.0f} ms of host syncs, left out of "
                    f"the rate)" if bridge else ""))
    return out


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


def phase_problem_converge(dev, name: str, n: int) -> dict:
    """The golden-cell script at n peers: converge, a full-width data
    flip through `apply_coalesced`, one join + one leave, converge."""
    import numpy as np
    from repro_torch.engine import L2Thresh, MeanMonitor

    prob = (MeanMonitor(tau=0.0, scale=256) if name == "mean"
            else L2Thresh(tau=1.0, dim=2))
    eng, rng = make_problem(name, prob, n, dev, seed=21)
    out = {}
    for stage in (1, 2, 3):
        if stage == 2:
            eng.apply_coalesced(np.arange(n), problem_data(name, n, rng, 1))
        elif stage == 3:
            free = np.setdiff1d(np.arange(1, 1 << 16, dtype=np.uint64),
                                eng.ring.addrs % (1 << 16))
            eng.join(int(free[3]), vote=problem_data(name, 1, rng, 1)[0])
            eng.leave(0)
        truth = prob.global_output(eng.data())
        sync(dev)
        t0, c0, m0 = time.perf_counter(), eng.t, eng.messages_sent
        res = eng.run_until_converged(truth=truth, max_cycles=20_000)
        sync(dev)
        dt = time.perf_counter() - t0
        cyc = eng.t - c0
        assert res["converged"] == 1.0, f"{name} stage {stage} did not converge"
        assert eng.dropped == 0, "messages dropped"
        eng.check_conservation()
        assert (eng.outputs() == truth).all()
        msgs = eng.messages_sent - m0
        out[f"stage{stage}"] = dict(truth=truth, cycles=cyc,
                                    messages_per_peer=msgs / eng.n,
                                    cycles_per_s=cyc / dt if dt else 0.0,
                                    seconds=dt)
        log(f"  {name} n={eng.n} stage {stage}: converged to {truth} in {cyc} "
            f"cycles, {msgs / eng.n:.3f} messages/peer, "
            f"{cyc / dt if dt else 0.0:.1f} cycles/s, dropped 0, "
            f"conservation holds")
    return out


def phase_big_churn(dev, n: int, events: int, gap: int):
    """L2 at n peers: the init storm, then `events` churn events `gap`
    cycles apart (and the cycles to make up 100). Returns the engine and
    its figures."""
    from repro_torch.core.churn import random_schedule
    from repro_torch.engine import L2Thresh

    sync(dev)
    t0 = time.perf_counter()
    eng, _ = make_problem("l2", L2Thresh(tau=1.0, dim=2), n, dev, seed=23)
    sync(dev)
    t_init = time.perf_counter() - t0
    sched = random_schedule(eng.ring, events, seed=24, spacing=gap)
    lead = 100 - events * gap
    t_churn = t_cyc = 0.0
    t0 = time.perf_counter()
    eng.step(lead)
    sync(dev)
    t_cyc += time.perf_counter() - t0
    for op, g in zip(sched.ops, sched.gaps):
        t0 = time.perf_counter()
        if op[0] == "join":
            eng.join(op[1], vote=op[2])
        else:
            eng.leave(op[1])
        sync(dev)
        t1 = time.perf_counter()
        eng.step(int(g))
        sync(dev)
        t_churn += t1 - t0
        t_cyc += time.perf_counter() - t1
    assert eng.t == 100, eng.t
    assert eng.dropped == 0, "messages dropped at n=1e6 (L2)"
    cons = eng.check_conservation()
    stats = {"init_s": t_init, "cycles_per_s": 100 / t_cyc,
             "churn_event_ms": t_churn * 1e3 / events,
             "deferral_rate": eng.deferral_rate}
    log(f"  L2 n={n}: init storm {t_init:.2f} s (pad {eng.pad}, wheel "
        f"{nbytes(eng._st.wheel) / 1e9:.2f} GB at row width {eng.roww}); "
        f"100 cycles at {100 / t_cyc:.1f} cycles/s with {events} churn "
        f"events ({t_churn * 1e3 / events:.1f} ms each on the host clock); "
        f"n now {eng.n}; deferral_rate {eng.deferral_rate:.4f}; in flight "
        f"{cons['live']}; dropped 0, conservation holds")
    return eng, stats


def phase_big_l2_any_dim(dev, n: int, dim: int, cycles: int):
    """L2 at data width `dim` with its default cover (the general kernel)
    at n peers: the init storm, then `cycles` cycles. Returns the engine
    and its figures."""
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import L2Thresh, make_engine
    from repro_torch.kernels import wheel as W
    from repro_torch.kernels.wheel import LAUNCHES

    rng = np.random.default_rng(41)
    ring = Ring.random(n, 32, seed=41)
    c = np.zeros(dim)
    c[:2] = 0.6, -0.8
    data = rng.normal(1.3 * c, 0.9, (n, dim))
    prob = L2Thresh(tau=1.0, dim=dim)
    sync(dev)
    t0 = time.perf_counter()
    eng = make_engine("torch", ring, data, seed=42, device=dev,
                      capacity_per_peer=8, problem=prob)
    sync(dev)
    t_init = time.perf_counter() - t0
    k0 = LAUNCHES["threshold_step_l2_general"]
    t0 = time.perf_counter()
    eng.step(cycles)
    sync(dev)
    dt = time.perf_counter() - t0
    k = LAUNCHES["threshold_step_l2_general"] - k0
    # the kernel against its plain version on this engine's own inputs:
    # every threshold_step call of two more cycles, on clones of its
    # inputs, the kernel run as the engine runs it
    real, held = eng._thresh, []

    def check(problem, *args):
        clones = [a.clone() for a in args]
        got = real(problem, *args)
        want = W.threshold_step_reference(problem, *clones)
        assert max_abs_err(got, want) == 0, (
            f"the general L2 kernel differs from its plain version on the "
            f"cycle t={eng.t}")
        held.append(int(args[0].shape[0]))
        return got

    eng._thresh = check
    try:
        eng.step(2)
    finally:
        eng._thresh = real
    assert held, "no threshold_step call in two cycles"
    assert eng.dropped == 0, f"messages dropped (L2 D={dim}, n={n})"
    cons = eng.check_conservation()
    stats = {"dim": dim, "ndirs": int(prob.U.shape[0]), "init_s": t_init,
             "cycles_per_s": cycles / dt,
             "general_launches_per_cycle": k / cycles,
             "checked_rows": held,
             "wheel_gb": nbytes(eng._st.wheel) / 1e9, "row_width": eng.roww,
             "deferral_rate": eng.deferral_rate}
    log(f"  L2 D={dim} (M={stats['ndirs']}) n={n}: init storm {t_init:.2f} "
        f"s (pad {eng.pad}, wheel {stats['wheel_gb']:.2f} GB at row width "
        f"{eng.roww}); {cycles} cycles in {dt:.2f} s = {cycles / dt:.1f} "
        f"cycles/s; the general L2 kernel {k / cycles:.2f} launches a "
        f"cycle; equal to its plain version on the {len(held)} calls of "
        f"2 more cycles ({held} rows); deferral_rate "
        f"{eng.deferral_rate:.4f}; in flight {cons['live']}; dropped 0, "
        f"conservation holds")
    return eng, stats


def device_events(dev, fn, warmup=None, cpu: bool = True):
    """Run `fn` once under the profiler: (wall seconds, the device-side
    events by name: kernels, copies, memsets). With `warmup`, that runs
    first, in the profiler's warm-up step (traced, not kept; the step's
    own annotation, which spans its device work, is left out), and the
    host waits 20 ms before `fn` and after it: a session drops device
    events that land near its edges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = ([ProfilerActivity.CPU] if cpu or dev.type != "cuda" else []) + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    steps = (None if warmup is None
             else schedule(wait=0, warmup=1, active=1, repeat=1))
    with profile(activities=acts, schedule=steps) as prof:
        if warmup is not None:
            warmup()
            sync(dev)
            prof.step()
            time.sleep(0.02)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
        if warmup is not None:
            time.sleep(0.02)
            prof.step()
    return wall, [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]


def profile_churn_event(dev, eng, addr: int) -> dict:
    """Device time and wall of one join at `addr` (the event path: row
    shift, fence and re-lane over the whole wheel, movers, ALERTs)."""
    wall, ev = device_events(dev, lambda: eng.join(addr, vote=(0.0, 0.0)))
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    launches = sum(e.count for e in ev)
    log(f"  one join at n={eng.n}: wall {wall * 1e3:.2f} ms profiled, device "
        f"busy {dev_ms:.2f} ms in {launches} device launches")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  "
            f"{e.key[:90]}")
    return {"join_wall_ms": wall * 1e3, "join_device_ms": dev_ms,
            "join_launches": launches}


def phase_profile(dev, eng, cycles: int, kernel: str = None,
                  count_as: str = None) -> dict:
    """Device time by kernel over a short window of cycles (device-side
    events only: kernels, copies, memsets). Returns the wall and device
    ms and the device launches per cycle, and with `kernel` the device ms
    a cycle and the share of the device time of the events whose name
    holds it. A session with fewer device events than the wrappers
    counted launches in it, or with `kernel`'s events other than the
    launches counted as `count_as`, is refused and profiled again."""
    from repro_torch.kernels.wheel import LAUNCHES

    eng.step(2)
    sync(dev)
    t0 = time.perf_counter()
    eng.step(cycles)
    sync(dev)
    wall0 = time.perf_counter() - t0
    for _ in range(3):  # refuse a session that dropped device events
        k0 = {}
        wall, ev = device_events(
            dev, lambda: (k0.update(LAUNCHES), eng.step(cycles)),
            warmup=lambda: eng.step(2))
        counted = {k: v - k0[k] for k, v in LAUNCHES.items()}
        dev_us = sum(e.self_device_time_total for e in ev)
        launches = sum(e.count for e in ev)
        k_n = (sum(e.count for e in ev if kernel in e.key)
               if kernel is not None else None)
        if dev.type != "cuda" or (
                dev_us > 0 and launches >= sum(counted.values())
                and (kernel is None or k_n == counted[count_as])):
            break
        log(f"  profile refused: {launches} device events for "
            f"{sum(counted.values())} counted launches"
            + ("" if kernel is None else
               f"; {k_n} {kernel} events for {counted[count_as]}"))
    else:
        raise RuntimeError("three profiles of the cycle dropped events")
    log(f"  profile of {cycles} cycles at n={eng.n}: wall {wall0 * 1e3 / cycles:.2f}"
        f" ms/cycle unprofiled, {wall * 1e3 / cycles:.2f} profiled; device "
        f"busy {dev_us / 1e3 / cycles:.2f} ms/cycle in {launches / cycles:.0f}"
        f" device launches ({100 * dev_us / 1e3 / (wall0 * 1e3):.0f}% of the "
        f"unprofiled wall)")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / cycles:9.1f} us/cycle "
            f"{e.count / cycles:5.1f}x  {e.key[:90]}")
    out = {"wall_ms_per_cycle": wall0 * 1e3 / cycles,
           "device_ms_per_cycle": dev_us / 1e3 / cycles,
           "launches_per_cycle": launches / cycles}
    if kernel is not None:
        k_us = sum(e.self_device_time_total for e in ev if kernel in e.key)
        out.update(kernel_ms_per_cycle=k_us / 1e3 / cycles,
                   kernel_launches_per_cycle=k_n / cycles,
                   kernel_share=k_us / dev_us if dev_us else 0.0)
        log(f"    {kernel}: {k_us / 1e3 / cycles:.4f} ms/cycle in "
            f"{k_n / cycles:.1f} launches, {100 * out['kernel_share']:.2f}% "
            f"of the cycle's device time")
    return out


# -- phase 8: the training substrate's kernels vs their plain versions ------

# stated tolerances against the plain version on the card, per element
# |kernel - plain| <= rtol |plain| + atol: threshold_gate exact; rglru
# (forward, and the backward's da, du) and flash o in bfloat16 within two
# bfloat16 rounding steps (2^-6 relative: the kernel's float32 state or
# sums round differently before the bf16 store), the backward's
# da = G h_prev within four (a product of two such values, rounded);
# flash lse in float32 from the same bf16 inputs, summed in another order
TOL = {"threshold_gate": (0.0, 0.0), "rglru_scan": (2 ** -6, 1e-3),
       "rglru_scan_bwd": (2 ** -5, 1e-3), "flash_attention_fwd": (2 ** -6,
                                                                 2 ** -8),
       "flash_lse": (1e-5, 1e-3)}
SMOLLM_PARAMS = 134_515_008  # SmolLM-135M's parameter count (30 layers)


def float_err(got, want, tol_name: str) -> float:
    """Max abs error of `got` against `want`; asserts every element
    within the stated tolerance TOL[tol_name]."""
    import torch

    rtol, atol = TOL[tol_name]
    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if g.numel():
            d = (g.float() - w.float()).abs()
            err = max(err, d.max().item())
            bad = int((d > rtol * w.float().abs() + atol).sum())
            assert bad == 0, (f"{tol_name}: {bad} elements outside rtol "
                              f"{rtol}, atol {atol} (max abs err "
                              f"{d.max().item():.3g})")
    return err


def band_pairs(sq: int, causal: bool, window, skv: int = None) -> int:
    """Visible (query, key) pairs of one head at q_offset 0 over `skv`
    keys (Sq when None)."""
    skv = sq if skv is None else skv
    tot = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        tot += hi - lo + 1
    return tot


def clocks_under(fn, dev, seconds: float = 2.0):
    """(median SM clock in MHz, median power draw in W) that nvidia-smi
    samples every 50 ms while `fn` runs back to back for `seconds`; None
    off the card. Device times of one kernel differ between the cards of
    a pool: this says whether the clock moved with them."""
    import torch

    if dev.type != "cuda":
        return None
    smi = subprocess.Popen(
        ["nvidia-smi", "-i", str(dev.index or 0), "-lms", "50",
         "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize(dev)
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.count(",") == 1 and "N/A" not in line]
    if not rows:
        return None
    mid = lambda xs: sorted(xs)[len(xs) // 2]
    return mid([r[0] for r in rows]), mid([r[1] for r in rows])


def sdpa_args(q, causal: bool, window) -> dict:
    """`scaled_dot_product_attention`'s keywords for q's GQA attention:
    is_causal, or a band as an explicit boolean mask."""
    import torch

    kw = {"enable_gqa": True}
    if window:
        i = torch.arange(q.shape[2], device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & (
            i[None, :] > i[:, None] - window)
    else:
        kw["is_causal"] = causal
    return kw


def sdpa_time(dev, q, k, v, causal: bool, window, iters: int):
    """One PyTorch call computing the same attention (the yardstick):
    (ms, backend, the call) of `scaled_dot_product_attention`. Causal GQA
    uses is_causal; a band passes an explicit boolean mask, and the first
    backend that accepts it is named."""
    import warnings

    import torch
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    kw = sdpa_args(q, causal, window)
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(be=be):
            # a backend that refuses the inputs warns why, then raises
            with sdpa_kernel(be), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                return Fn.scaled_dot_product_attention(q, k, v, **kw)
        try:
            call()
            sync(dev)
            return time_ms(call, dev, iters), be.name, call
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend ran")


def record_row(rows: dict, dev, iters: int, name, kernel, plain, err, io,
               flops, flop_rate, piters, tag="main", library=None) -> None:
    """Time `kernel` and `plain` (CUDA events per call, profiler device
    ms) and file the figures under rows[name]["shapes"][tag] (and on
    rows[name] itself for tag "main") beside the bound: max(io bytes at
    the HBM rate, flops at `flop_rate`)."""
    call = time_ms(kernel, dev, iters)
    pcall = time_ms(plain, dev, piters, warmup=1)
    ms = device_ms(kernel, dev, iters)
    pms = device_ms(plain, dev, piters)
    t_bytes, t_ops = io / HBM_BYTES_PER_S, flops / flop_rate
    b_ms = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    fig = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
           "bound_ms": b_ms, "bound_by": by,
           "library_ms": None if library is None else library[0],
           "call_ms": call}
    if library is not None:
        fig["library"] = f"scaled_dot_product_attention ({library[1]})"
    if flop_rate == BF16_FLOPS_PER_S:
        fig["bound_ms_at_fp32_cuda_cores"] = max(
            t_bytes, flops / ALU_OPS_PER_S) * 1e3
    rows.setdefault(name, {}).setdefault("shapes", {})[tag] = fig
    if tag == "main":
        rows[name].update(fig)
    log(f"  {name} {tag}: max_abs_err {err:.3g} (rtol, atol "
        f"{TOL[name]})  "
        f"device: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by}); per call with launch: kernel {call:.4f} "
        f"ms, plain {pcall:.4f} ms"
        + ("" if library is None else
           f"; SDPA ({library[1]}) {library[0]:.4f} ms")
        + f"  [{io / 1e6:.1f} MB moved, {flops / 1e9:.2f} GFLOP]")


def flash_rows(dev, rows: dict, iters: int, gen, cases,
               clocks: bool = True) -> None:
    """`flash_attention_fwd` o and lse against the plain pair schedule on
    bf16 inputs drawn from `gen` at each (tag, shape) of `cases`: (B, Hq,
    Hkv, S, D, window), causal over Skv = S keys, or (B, Hq, Hkv, Sq, D,
    window, Skv, causal), where D is the head width or a (Dqk, Dv) pair;
    timed beside its bound (operations at the bf16 tensor-core rate: 2
    (Dqk + Dv) flops a visible pair) and SDPA; with `clocks`, the SM
    clock and power under the kernel and under SDPA."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     pair_fwd)

    for tag, (bb, hq, hkv, sq, dh, window, *rest) in cases:
        skv, causal = rest or (sq, True)
        dh, dv = dh if isinstance(dh, tuple) else (dh, dh)
        draw = lambda *shape: torch.randn(shape, generator=gen,
                                          device=dev).bfloat16()
        q = draw(bb, hq, sq, dh)
        k = draw(bb, hkv, skv, dh)
        v = draw(bb, hkv, skv, dv)
        got = flash_attention_fwd(q, k, v, causal, window)
        want = pair_fwd(q, k, v, causal, window, None)
        sync(dev)
        err = float_err(got[:1], want[:1], "flash_attention_fwd")
        err_l = float_err(got[1:], want[1:], "flash_lse")
        pairs = band_pairs(sq, causal, window, skv) * bb * hq
        # q, k, v read once, o and the float32 lse written once
        io = (q.numel() + k.numel() + v.numel() + bb * hq * sq * dv) * 2 \
            + 4 * bb * hq * sq
        lib = sdpa_time(dev, q, k, v, causal, window, iters)
        kern = lambda: flash_attention_fwd(q, k, v, causal, window)
        record_row(rows, dev, iters, "flash_attention_fwd", kern,
                   lambda: pair_fwd(q, k, v, causal, window, None), err, io,
                   2 * (dh + dv) * pairs, BF16_FLOPS_PER_S,
                   max(1, iters // 4), tag, library=lib[:2])
        fig = rows["flash_attention_fwd"]["shapes"][tag]
        fig["shape"] = [bb, hq, hkv, sq, dh, window, skv, causal] + (
            [] if dv == dh else [dv])
        fig["lse_max_abs_err"] = err_l
        if clocks:
            fig["sm_mhz_power_w"] = {"kernel": clocks_under(kern, dev),
                                     "library": clocks_under(lib[2], dev)}
            log(f"    SM clock (MHz), power (W) under the kernel "
                f"{fig['sm_mhz_power_w']['kernel']}, under SDPA "
                f"{fig['sm_mhz_power_w']['library']}")
        del q, k, v, got, want


def phase_train_kernels(dev, iters: int, gate_n: int = SMOLLM_PARAMS,
                        scan=(1, 4096, 4096),
                        rg_attn=(1, 16, 1, 4096, 256, 2048),
                        sm_attn=(4, 9, 3, 2048, 64)) -> dict:
    """threshold_gate, rglru_scan and flash_attention_fwd against their
    plain versions on the card at the trainer's shapes, timed."""
    import torch
    from repro_torch.kernels.rglru import (linear_scan, linear_scan_reference,
                                           rglru_scan)
    from repro_torch.kernels.threshold_gate import (threshold_gate,
                                                    threshold_gate_reference)

    gen = torch.Generator(device=dev).manual_seed(2027)
    rows = {}
    record = lambda *a, **kw: record_row(rows, dev, iters, *a, **kw)

    # threshold_gate: the sync's float32 delta and residual (exact)
    for n, tau, tag in ((gate_n, 1e-4, "main"), (1_000_003, 0.0, "tau0")):
        g = torch.randn(n, generator=gen, device=dev) * 1e-4
        r = torch.randn(n, generator=gen, device=dev) * 1e-4
        want, got = threshold_gate_reference(g, r, tau), threshold_gate(g, r, tau)
        sync(dev)
        err = float_err(got[:2], want[:2], "threshold_gate")
        assert int(got[2]) == int(want[2]), \
            f"threshold_gate ({tag}): counts differ"
        if tau <= 0:
            assert int(got[2]) == n
        record("threshold_gate", lambda: threshold_gate(g, r, tau),
               lambda: threshold_gate_reference(g, r, tau), err, 16 * n,
               3 * n, ALU_OPS_PER_S, max(1, iters // 4), tag)
        log(f"    n={n} tau={tau}: {int(got[2])} sent, counts equal")
        del g, r, want, got

    # rglru_scan: forward and the reverse scan the backward runs, a = 1 (a
    # running sum float32 holds exactly: equal), then the Function's
    # backward. a, u and h (~100 MB) are twice the L2, so a caller finds
    # them mostly cold: each row's `ms` is timed with the L2 evicted
    # before every call, the back-to-back profiler time is `warm_l2_ms`
    b, t, w = scan
    a = (torch.rand((b, t, w), generator=gen, device=dev) * 0.2 + 0.8
         ).bfloat16()
    u = (torch.randn((b, t, w), generator=gen, device=dev) * 0.1).bfloat16()
    io, flops = 3 * a.numel() * 2, 2 * a.numel()
    for tag, rev in (("main", False), ("reverse", True)):
        got = rglru_scan(a, u, reverse=rev)
        want = linear_scan_reference(a, u, reverse=rev)
        sync(dev)
        err = float_err(got, want, "rglru_scan")
        kern = lambda rev=rev: rglru_scan(a, u, reverse=rev)
        record("rglru_scan", kern,
               lambda rev=rev: linear_scan_reference(a, u, reverse=rev), err,
               io, flops, ALU_OPS_PER_S, max(1, iters // 4), tag)
        fig = rows["rglru_scan"]["shapes"][tag]
        fig["warm_l2_ms"], fig["ms"] = fig["ms"], cold_ms(kern, dev, iters)
        if tag == "main":
            rows["rglru_scan"].update(fig)
        log(f"    {tag} with the L2 evicted before each call: {fig['ms']} ms "
            f"(back to back {fig['warm_l2_ms']} ms)")
    ones = torch.ones_like(a)
    eighths = (torch.randint(-8, 9, (b, t, w), generator=gen, device=dev)
               / 8).bfloat16()
    for rev in (False, True):
        got = rglru_scan(ones, eighths, reverse=rev)
        want = linear_scan_reference(ones, eighths, reverse=rev)
        sync(dev)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), \
            f"rglru_scan: a = 1 running sum differs (reverse={rev})"
    rows["rglru_scan"]["cumsum_exact"] = True
    log("    a = 1, u in eighths (a running sum held exactly): equal to "
        "the plain version, forward and reverse")
    del ones, eighths, got, want
    cot = torch.randn((b, t, w), generator=gen, device=dev).bfloat16()
    grads = []
    for use_kernel in (True, False):
        xs = [x.clone().requires_grad_() for x in (a, u)]
        h, _ = linear_scan(*xs, use_kernel=use_kernel)
        (h.float() * cot.float()).sum().backward()
        grads.append([x.grad for x in xs])
    sync(dev)
    err_b = float_err(*grads, "rglru_scan_bwd")
    rows["rglru_scan"]["backward_max_abs_err"] = err_b
    log(f"    backward (the reverse scan on the kernel vs plain): da, du "
        f"max_abs_err {err_b:.3g} (rtol, atol {TOL['rglru_scan_bwd']})")
    del a, u, cot, grads, xs, h

    # flash_attention_fwd: RG-9B's MQA band, then SmolLM's causal GQA
    flash_rows(dev, rows, iters, gen, (("main", rg_attn),
                                       ("smollm", (*sm_attn, None))))
    return rows


# -- phases 9 and 10: the trainer ---------------------------------------------

def train_args(**kw):
    from repro_torch.launch.train import parser

    args = parser().parse_args([])
    args.log_every = 1
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def phase_train_rg(dev, layers: int = 3, batch: int = 1, seq: int = 4096,
                   steps: int = 4, smoke: bool = False):
    """RecurrentGemma-9B at full width, depth `layers`, through
    `run_plain`, then its first step with every kernel's plain version.
    Returns (figures, launch counts of the kernel run, (cfg, params,
    args) for the profile)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.launch.train import run_plain

    base = (get_smoke_config if smoke else get_config)("recurrentgemma-9b")
    cfg = dataclasses.replace(base, num_layers=layers)
    kw = dict(arch="recurrentgemma-9b", batch=batch, seq_len=seq,
              device=str(dev))
    args = train_args(steps=steps, **kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    res = run_plain(args, cfg=cfg)
    sync(dev)
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else float("nan"))
    assert all(np.isfinite(res.losses)), f"non-finite loss {res.losses}"
    params, res.params = res.params, None
    n_params = sum(p.numel() for p in _leaves(params))
    # the first step (before any update, so the schedule's length does
    # not enter) with every kernel's plain version, from the same init
    plain = run_plain(train_args(steps=1, **kw),
                      cfg=dataclasses.replace(cfg, use_kernels=False))
    plain.params = None
    d_loss = abs(plain.losses[0] - res.losses[0]) / abs(plain.losses[0])
    d_norm = abs(plain.grad_norms[0] - res.grad_norms[0]) / plain.grad_norms[0]
    assert d_loss <= 5e-3, f"first-step loss differs from plain: {d_loss}"
    assert d_norm <= 2e-2, f"first-step grad norm differs from plain: {d_norm}"
    later = sorted(res.step_seconds[1:])
    steady = later[len(later) // 2]
    fig = {"layers": layers, "params": n_params, "batch": batch, "seq": seq,
           "losses": res.losses, "grad_norms": res.grad_norms,
           "step_ms": [x * 1e3 for x in res.step_seconds],
           "median_step_ms": steady * 1e3,
           "tokens_per_s": batch * seq / steady, "peak_gb": peak,
           "plain_first_loss": plain.losses[0],
           "plain_first_grad_norm": plain.grad_norms[0],
           "first_step_rel_diff": {"loss": d_loss, "grad_norm": d_norm}}
    log(f"  RG-9B depth {layers} ({n_params / 1e9:.3f} B params), batch "
        f"{batch} x {seq}: losses {[round(x, 4) for x in res.losses]}; "
        f"median step {steady * 1e3:.1f} ms = {batch * seq / steady:.0f} "
        f"tokens/s; peak memory {peak:.1f} GB; first step vs plain kernels: "
        f"loss rel diff {d_loss:.2e} (tol 5e-3), grad norm {d_norm:.2e} "
        f"(tol 2e-2)")
    return fig, counts, (cfg, params, args)


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)


def profile_train_step(dev, cfg, params, args) -> dict:
    """Device time by kernel over one training step (a fresh optimizer
    state; one step to warm up first)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamWConfig, init_state

    opt_state = init_state(params)
    step = S.make_train_step(cfg, AdamWConfig(lr=args.lr), args.schedule, 10)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.batch,
                                  seed=7))
    batch = [torch.from_numpy(x).to(dev) for x in data.next_batch()]
    step(params, opt_state, *batch)
    sync(dev)
    t0 = time.perf_counter()
    step(params, opt_state, *batch)
    sync(dev)
    wall0 = time.perf_counter() - t0
    wall, ev = device_events(dev, lambda: step(params, opt_state, *batch))
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    launches = sum(e.count for e in ev)
    log(f"  profile of one RG-9B step: wall {wall0 * 1e3:.1f} ms unprofiled, "
        f"{wall * 1e3:.1f} profiled; device busy {dev_ms:.1f} ms in "
        f"{launches} device launches ({100 * dev_ms / (wall0 * 1e3):.0f}% of "
        f"the unprofiled wall)")
    top = []
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:5d}x  "
            f"{e.key[:90]}")
        top.append([e.key[:90], e.self_device_time_total / 1e3, e.count])
    return {"wall_ms": wall0 * 1e3, "device_busy_ms": dev_ms,
            "busy_share": dev_ms / (wall0 * 1e3), "launches": launches,
            "top": top}


def phase_train_smollm(dev, steps: int = 12, batch: int = 8,
                       seq: int = 2048, smoke: bool = False):
    """SmolLM-135M (full config) in threshold mode through
    `run_threshold`, then the same run with plain kernels."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.launch.train import run_threshold

    cfg = (get_smoke_config if smoke else get_config)("smollm-135m")
    kw = dict(arch="smollm-135m", steps=steps, batch=batch, seq_len=seq,
              sync="threshold", pods=2, compress_tau=1e-4, max_inner=4,
              device=str(dev))
    reset_launches()
    t0 = time.perf_counter()
    res = run_threshold(train_args(**kw), cfg=cfg)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_params = sum(p.numel() for p in _leaves(res.params[0]))
    res.params = None
    plain = run_threshold(train_args(**kw),
                          cfg=dataclasses.replace(cfg, use_kernels=False))
    plain.params = None
    dense = res.n_syncs * n_params * 4
    assert all(np.isfinite(res.losses)), f"non-finite loss {res.losses}"
    assert res.n_syncs >= 3, f"only {res.n_syncs} syncs"
    assert 0 < res.sent_bytes < dense, (res.sent_bytes, dense)
    assert res.n_syncs == plain.n_syncs and \
        res.sync_steps == plain.sync_steps, (res.sync_steps, plain.sync_steps)
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(res.losses, plain.losses))
    assert d_loss <= 1e-2, f"losses differ from the plain run: {d_loss}"
    steady = sorted(res.step_seconds[1:])[len(res.step_seconds[1:]) // 2]
    fig = {"params": n_params, "steps": steps, "syncs": res.n_syncs,
           "sync_steps": res.sync_steps, "sent_bytes": res.sent_bytes,
           "dense_bytes": dense, "losses": res.losses,
           "plain_losses": plain.losses, "plain_sent_bytes": plain.sent_bytes,
           "max_rel_loss_diff": d_loss, "median_step_ms": steady * 1e3,
           "tokens_per_s": batch * seq / steady, "wall_s": wall}
    log(f"  SmolLM-135M threshold: {res.n_syncs} syncs at steps "
        f"{res.sync_steps}, sent {res.sent_bytes} bytes of {dense} dense "
        f"({100 * res.sent_bytes / dense:.2f} %; plain run {plain.sent_bytes}); "
        f"losses {[round(x, 4) for x in res.losses]}; max rel diff to the "
        f"plain run {d_loss:.2e} (tol 1e-2); median step (2 pods) "
        f"{steady * 1e3:.1f} ms = {batch * seq / steady:.0f} tokens/s")
    return fig, counts



# -- phase 18: the control plane in one process --------------------------------

def phase_drills(dev, hosts: int = 4096, trials: int = 16) -> tuple:
    """`runtime.elastic`'s drills on the torch engine at `hosts` peers
    (`capacity_per_peer` 8): `churn_drill` (8 joins and leaves one cycle
    apart after convergence, which leave some peers on a wrong output:
    the drill must reconverge) and `decision_latency_profile` (`trials`
    quorum votes as one `BatchedTorchEngine`), with every kernel and
    with every plain version: the two dicts equal. Returns (the record,
    the kernels-on runs' launches)."""
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.runtime import elastic

    got, counts = {}, None
    for wk in ("auto", "none"):
        kw = dict(backend="torch", seed=0, device=dev, wheel_kernels=wk,
                  capacity_per_peer=8)
        reset_launches()
        t0 = time.perf_counter()
        c = elastic.churn_drill(hosts=hosts, events=8, spacing=1, **kw)
        t1 = time.perf_counter()
        d = elastic.decision_latency_profile(hosts=hosts, trials=trials, **kw)
        sync(dev)
        got[wk] = {"churn": c, "decision": d, "churn_s": t1 - t0,
                   "decision_s": time.perf_counter() - t1}
        if wk == "auto":
            counts = launch_counts()
    a, b = got["auto"], got["none"]
    assert a["churn"] == b["churn"] and a["decision"] == b["decision"], (
        "the drills differ between kernels and plain versions")
    c, d = a["churn"], a["decision"]
    assert c["converged"] == 1.0 and c["invalid"] == 0.0, c
    assert c["reconverge_cycles"] > 0, f"the churn broke no convergence: {c}"
    assert d["converged"] == 1.0, d
    log(f"  churn_drill hosts={hosts}: {c['joins']} joins + {c['leaves']} "
        f"leaves a cycle apart, warm-up {c['warmup_cycles']} cycles, "
        f"reconverged in {c['reconverge_cycles']} cycles and "
        f"{c['reconverge_messages']} messages (n {c['hosts_end']}); "
        f"decision_latency_profile "
        f"{trials} trials: cycles p50/p95/max {d['cycles_p50']:.0f} / "
        f"{d['cycles_p95']:.1f} / {d['cycles_max']:.0f}, messages a peer "
        f"p50 {d['msgs_per_peer_p50']:.2f}; equal with every kernel and with "
        f"every plain version; kernels {a['churn_s']:.2f} + "
        f"{a['decision_s']:.2f} s, plain {b['churn_s']:.2f} + "
        f"{b['decision_s']:.2f} s")
    return got, counts


def phase_resume(dev, steps: int = 6, batch: int = 8, seq: int = 2048,
                 every: int = 2, fail_at: int = 4):
    """SmolLM-135M (full config) through `run_plain`: `steps` steps
    uninterrupted, then with checkpoints every `every` steps and a
    failure injected at step `fail_at` (restored from the newest
    checkpoint, replayed): from `fail_at` on the losses, and the final
    parameters, equal the uninterrupted run's bit for bit; where they
    do not, the step's nondeterministic ops are named (torch's
    deterministic-algorithm check on one more step) and the losses must
    hold PERF.md §2's first-step bound, 5e-3 relative. Then a blocking
    save and a restore of the final state, timed, and its bytes.
    Returns (the record, the launches of the two runs)."""
    import shutil
    import warnings

    import numpy as np
    import torch
    from repro_torch.ckpt import checkpoint as C
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.launch.train import run_plain
    from repro_torch.optim.adamw import init_state

    cfg = get_config("smollm-135m")
    ck = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(arch="smollm-135m", steps=steps, batch=batch, seq_len=seq,
              device=str(dev), log_every=100)
    reset_launches()
    plain = run_plain(train_args(**kw), cfg=cfg)
    res = run_plain(train_args(ckpt_dir=os.path.join(ck, "run"),
                               ckpt_every=every, fail_at=fail_at, **kw),
                    cfg=cfg)
    sync(dev)
    counts = launch_counts()
    n_params = sum(p.numel() for p in _leaves(res.params))
    assert res.restored == [fail_at - 1 - (fail_at - 1) % every] and \
        res.steps[-(steps - res.restored[0] - 1):] == list(
            range(res.restored[0] + 1, steps)), (res.steps, res.restored)
    after = {s: x for s, x in zip(res.steps, res.losses)}
    got = [after[s] for s in range(fail_at, steps)]
    want = plain.losses[fail_at:]
    same_params = all(torch.equal(a, b) for a, b in
                      zip(_leaves(res.params), _leaves(plain.params)))
    exact = got == want and same_params
    rec = {"params": n_params, "steps": steps, "fail_at": fail_at,
           "restored_step": res.restored[0], "losses": plain.losses,
           "resumed_losses": got, "bit_identical": exact}
    if not exact:
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        dmax = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(_leaves(res.params), _leaves(plain.params)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                run_plain(train_args(**dict(kw, steps=1)), cfg=cfg)
            finally:
                torch.use_deterministic_algorithms(False)
        named = sorted({str(w.message).split(" does not have")[0]
                        for w in caught
                        if "deterministic" in str(w.message)})
        rec.update(max_rel_loss_diff=rel, max_abs_param_diff=dmax,
                   nondeterministic_ops=named)
        assert rel <= 5e-3, f"resumed losses off by {rel} (bound 5e-3)"
        log(f"  not bit-identical: nondeterministic on the card: {named}")
    # a blocking save and a restore of the final state, timed
    target = {"params": res.params, "opt": init_state(res.params)}
    last = C.latest_step(os.path.join(ck, "run"))
    t0 = time.perf_counter()
    tree, _ = C.restore(os.path.join(ck, "run"), last, target)
    sync(dev)
    t_restore = time.perf_counter() - t0
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tree["params"]),
                                                 _leaves(res.params)))
    t0 = time.perf_counter()
    final = C.save(os.path.join(ck, "timed"), last, tree)
    t_save = time.perf_counter() - t0
    nbytes_ck = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(final) for f in fs)
    shutil.rmtree(ck, ignore_errors=True)
    steady = sorted(plain.step_seconds[1:])[len(plain.step_seconds[1:]) // 2]
    rec.update(save_ms=t_save * 1e3, restore_ms=t_restore * 1e3,
               save_async_ms=[x * 1e3 for x in res.ckpt_seconds],
               resume_restore_ms=[x * 1e3 for x in res.restore_seconds],
               checkpoint_bytes=nbytes_ck, median_step_ms=steady * 1e3)
    log(f"  SmolLM-135M run_plain, {n_params:,} parameters, batch {batch} x "
        f"{seq}, {steps} steps: a failure at step {fail_at} restored step "
        f"{res.restored[0]} and replayed; losses from step {fail_at} "
        f"{[round(x, 5) for x in got]} vs uninterrupted "
        f"{[round(x, 5) for x in want]}: "
        f"{'bit-identical, final parameters too' if exact else 'within bound'}"
        f"; checkpoint {nbytes_ck:,} bytes, blocking save {t_save * 1e3:.0f} "
        f"ms, restore {t_restore * 1e3:.0f} ms (in the run "
        f"{', '.join(f'{x * 1e3:.0f}' for x in res.restore_seconds)} ms; "
        f"save_async calls {', '.join(f'{x * 1e3:.0f}' for x in res.ckpt_seconds)}"
        f" ms); median step {steady * 1e3:.1f} ms")
    assert np.isfinite(res.losses).all()
    return rec, counts


# -- phase 15: batched trials ------------------------------------------------

SWEEP_MARGINS = (0.40, 0.45, 0.48, 0.52, 0.55, 0.60)
SWEEP_TRIALS = 4  # seeds per margin
SWEEP_MAX_CYCLES = 20_000
WHEEL_KERNELS_MAJ = ("stage_rows", "threshold_step", "due_dedup",
                     "descent_tail")


def grid_votes(n: int, margins, trials: int, seed: int):
    """(B, n) vote planes for the (margin x seed) grid, B = |margins| *
    trials, drawn as `benchmarks/sweep.py`'s `_grid_votes` draws them."""
    import numpy as np

    votes, truths, cells = [], [], []
    for mi, mu in enumerate(margins):
        for s in range(trials):
            rng = np.random.default_rng(seed + 1000 * mi + s)
            v = np.zeros(n, np.int64)
            v[rng.choice(n, int(round(n * mu)), replace=False)] = 1
            votes.append(v)
            truths.append(int(2 * v.sum() >= n))
            cells.append((mu, s))
    return np.stack(votes), np.asarray(truths), cells


def assert_trial_equal(bat, b: int, eng, where: str) -> None:
    import numpy as np
    from repro_torch.engine.convert import state_to_numpy

    sa, sb = state_to_numpy(bat.state(b)), state_to_numpy(eng._st)
    for f in sa:
        assert np.array_equal(sa[f], sb[f]), (
            f"trial {b}: state field {f} differs {where}")


def peak_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(dev) -> float:
    import torch

    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def count_cycles(bat) -> dict:
    """Count the batched engine's cycles and event reacts from now on."""
    e, c = bat._eng, {"cycles": 0, "reacts": 0}
    cycle, react = e._cycle, e._react

    def cyc(*a, **k):
        c["cycles"] += 1
        cycle(*a, **k)

    def rea(*a, **k):
        c["reacts"] += 1
        react(*a, **k)

    e._cycle, e._react = cyc, rea
    return c


def phase_batched_parity(dev, n: int) -> None:
    """Kernels-on batched engines against B serial kernels-on engines:
    B = 4 majority on 4 rings, B = 3 L2 (D = 2) on one ring; converge, a
    ragged `set_votes`, converge again (the trials then at different t);
    per trial the full state, the results and the outputs equal."""
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import L2Thresh, make_engine

    rng = np.random.default_rng(31)
    cases = []
    votes = np.stack([votes_at(n, mu, rng) for mu in (0.4, 0.45, 0.55, 0.6)])
    cases.append(("majority", [Ring.random(n, 32, seed=60 + b)
                               for b in range(4)], votes, None,
                  np.ones((4, 300), np.int64)))
    ring = Ring.random(n, 32, seed=64)
    data = np.stack([problem_data("l2", n, rng, 0) for _ in range(3)])
    cases.append(("l2", [ring] * 3, data, L2Thresh(tau=1.0, dim=2),
                  np.stack([problem_data("l2", 300, rng, 1)
                            for _ in range(3)])))
    for name, rings, data, prob, flip in cases:
        B = len(rings)
        kw = dict(device=dev, capacity_per_peer=8, problem=prob)
        bat = make_engine("torch", rings, data, seed=70, batch=B, **kw)
        ser = [make_engine("torch", rings[b], data[b], seed=70 + b, **kw)
               for b in range(B)]
        truths = [e.problem.global_output(e.data()) for e in ser]
        idx = np.full((B, flip.shape[1]), -1)
        idx[0, :5] = np.arange(5) * 11
        idx[B - 1] = np.arange(flip.shape[1]) * (n // flip.shape[1])
        # (trial 1 gets none, and still reacts)
        for stage in (1, 2):
            if stage == 2:
                bat.set_votes(idx, flip)
                for b, e in enumerate(ser):
                    keep = idx[b] >= 0
                    e.set_votes(idx[b][keep], flip[b][keep])
                truths = [e.problem.global_output(e.data()) for e in ser]
            t0 = bat.t
            res = bat.run_until_converged(truths, max_cycles=20_000)
            for b, e in enumerate(ser):
                assert e.run_until_converged(truths[b],
                                             max_cycles=20_000) == res[b], \
                    f"{name} trial {b} stage {stage}"
                assert_trial_equal(bat, b, e, f"({name}, stage {stage})")
            assert all(r["converged"] == 1.0 for r in res)
            assert (bat.dropped == 0).all()
            bat.check_conservation()
            np.testing.assert_array_equal(
                bat.outputs(), np.stack([e.outputs() for e in ser]))
            log(f"  {name} B={B} n={n} stage {stage}: cycles "
                f"{(bat.t - t0).tolist()} (t {bat.t.tolist()}), equal to "
                f"{B} serial engines in full state, results and outputs")


BATCHED_KEYS = ("_descent", "_dedup", "_thresh", "_stage")


def check_on_changes(bat, chk) -> None:
    """Re-arm `chk` whenever the set of stepping trials changes (the first
    cycle, each freeze, each chunk start), so that the batched cycle's
    kernels are checked on each form of its window."""
    e, seen = bat._eng, {"key": b"start"}
    cycle = e._cycle

    def cyc(active=None):
        key = None if active is None or active.all() else active.tobytes()
        if key != seen["key"]:
            seen["key"] = key
            chk.restart()
        cycle(active=active)

    e._cycle = cyc


def log_checks(chk, what: str) -> None:
    log(f"  {what}: the batched engine's kernels vs plain versions, exact on "
        f"{len(chk.checked)} cycles; rows per call (t: descent_tail [live] / "
        f"due_dedup / threshold_step / stage_rows) "
        + "; ".join(f"t={c['t']}: {c['descent_tail']} [{c['descent_live']}] "
                    f"/ {c['due_dedup']} / {c['threshold_step']} / "
                    f"{c['stage_rows']}" for c in chk.checked[:4])
        + ("" if len(chk.checked) <= 4 else
           f"; ... ({len(chk.checked) - 4} more)")
        + f"; {chk.seconds:.2f} s of checking left out of the rates")


def phase_sweep(dev, n: int):
    """The paper's sweep grid as one batched engine at n peers, to
    convergence, its wheel kernels held against their plain versions on
    the first cycle and whenever a trial freezes or a chunk starts; then
    a ragged flip and 3 cycles of every trial at its own t (the per-lane
    slot gather), checked on the first. Returns the figures and what the
    serial re-runs need."""
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine
    from repro_torch.kernels.wheel import launch_counts

    votes, truths, cells = grid_votes(n, SWEEP_MARGINS, SWEEP_TRIALS, 0)
    B = votes.shape[0]
    ring = Ring.random(n, 32, seed=0)
    peak_reset(dev)
    sync(dev)
    t0 = time.perf_counter()
    bat = make_engine("torch", ring, votes, seed=1, batch=B, device=dev,
                      capacity_per_peer=8)
    sync(dev)
    t_init = time.perf_counter() - t0
    wheel_gb = nbytes(bat._eng._st.wheel) / 1e9
    counts = count_cycles(bat)
    chk = CycleKernelCheck(bat._eng, dev, keys=BATCHED_KEYS)
    check_on_changes(bat, chk)
    k0 = launch_counts()
    t0 = time.perf_counter()
    res = bat.run_until_converged(truths, max_cycles=SWEEP_MAX_CYCLES)
    sync(dev)
    wall = time.perf_counter() - t0 - chk.seconds
    k1 = launch_counts()
    n_cycles = counts["cycles"]
    per_cycle = {k: (k1[k] - k0[k] - (counts["reacts"]
                                      if k == "threshold_step" else 0))
                 / n_cycles for k in WHEEL_KERNELS_MAJ}
    peak = peak_gb(dev)
    cyc = np.asarray([r["cycles"] for r in res])
    assert all(r["converged"] == 1.0 for r in res), "a sweep trial failed"
    assert (bat.dropped == 0).all(), "messages dropped in the sweep"
    bat.check_conservation()
    outs = bat.outputs()
    assert (outs == truths[:, None]).all(), "a trial off its truth"
    trial_cycles = int(cyc.sum())
    n_run = len(chk.checked)
    # every trial at its own t: a ragged flip (trial b flips b peers)
    t_sweep = bat.t
    assert len(set(t_sweep.tolist())) > 1
    idx = np.full((B, B), -1)
    for b in range(B):
        idx[b, :b] = np.arange(b) * (n // B)
    bat.set_votes(idx, 1 - np.take_along_axis(votes, np.maximum(idx, 0), 1))
    chk.restart()
    bat.step(3)
    sync(dev)
    chk.remove()
    assert (bat.t == t_sweep + 3).all() and n_run >= 2 and chk.complete()
    assert len(chk.checked) > n_run
    assert (bat.dropped == 0).all()
    bat.check_conservation()
    log_checks(chk, f"sweep B={B} n={n} ({n_run} checked cycles in the run, "
               f"then 1 of 3 cycles at t {t_sweep.min()}..{t_sweep.max()})")
    rows = []
    for mi, mu in enumerate(SWEEP_MARGINS):
        sl = slice(mi * SWEEP_TRIALS, (mi + 1) * SWEEP_TRIALS)
        rs = res[sl]
        rows.append({"margin": mu,
                     "converge_rate": float(np.mean([r["converged"]
                                                     for r in rs])),
                     "mean_cycles": float(np.mean([r["cycles"] for r in rs])),
                     "msgs_per_peer": float(np.mean([r["messages"] / n
                                                     for r in rs]))})
        log(f"  margin {mu:.2f}: converge rate {rows[-1]['converge_rate']:.2f}"
            f", mean cycles {rows[-1]['mean_cycles']:.1f}, messages/peer "
            f"{rows[-1]['msgs_per_peer']:.3f}")
    log(f"  B={B} n={n}: init {t_init:.2f} s (wheel {wheel_gb:.2f} GB), "
        f"{n_cycles} batched cycles in {wall:.2f} s, "
        f"{trial_cycles} trial-cycles = {trial_cycles / wall:.0f} "
        f"trial-cycles/s; wheel-kernel launches per batched cycle "
        f"{json.dumps(per_cycle)}; peak {peak:.2f} GB")
    del bat
    stats = {"B": B, "n": n, "init_s": t_init, "wheel_gb": wheel_gb,
             "batched_cycles": n_cycles, "wall_s": wall,
             "trial_cycles": trial_cycles,
             "trial_cycles_per_s": trial_cycles / wall,
             "launches_per_cycle": per_cycle, "peak_gb": peak,
             "kernel_checks": len(chk.checked), "check_s": chk.seconds,
             "margins": rows}
    ctx = {"ring": ring, "votes": votes, "truths": truths, "cells": cells,
           "res": res, "outs": outs, "per_cycle": per_cycle}
    return stats, ctx


def sweep_reruns(dev, ctx: dict) -> list:
    """The sweep's slowest and fastest trial re-run serially on
    `TorchEngine`: equal cycles, messages and outputs, and the single
    engine's wheel-kernel launches a cycle equal the batched engine's."""
    import numpy as np
    from repro_torch.engine import make_engine
    from repro_torch.kernels.wheel import launch_counts

    res, per_cycle = ctx["res"], ctx["per_cycle"]
    cyc = np.asarray([r["cycles"] for r in res])
    order = [int(np.argmax(cyc)), int(np.argmin(cyc))]
    serial = []
    for b in order:
        k0 = launch_counts()
        e = make_engine("torch", ctx["ring"], ctx["votes"][b], seed=1 + b,
                        device=dev, capacity_per_peer=8)
        sync(dev)
        t0 = time.perf_counter()
        r = e.run_until_converged(int(ctx["truths"][b]),
                                  max_cycles=SWEEP_MAX_CYCLES)
        sync(dev)
        w = time.perf_counter() - t0
        k1 = launch_counts()
        assert r == res[b], f"serial trial {b}: {r} != {res[b]}"
        assert (e.outputs() == ctx["outs"][b]).all()
        # the single engine's launches a cycle on the same problem (its
        # init react is one threshold_step launch)
        single = {k: (k1[k] - k0[k] - (1 if k == "threshold_step" else 0))
                  / r["cycles"] for k in WHEEL_KERNELS_MAJ}
        for k in WHEEL_KERNELS_MAJ:  # (no launches off the card)
            assert dev.type != "cuda" or per_cycle[k] == single[k] == 1.0, (
                k, per_cycle, single)
        cell = ctx["cells"][b]
        serial.append({"trial": b, "cell": cell, "cycles": r["cycles"],
                       "wall_s": w, "cycles_per_s": r["cycles"] / w})
        log(f"  serial trial {b} {cell}: {r['cycles']} cycles in {w:.2f} s"
            f" ({r['cycles'] / w:.1f} cycles/s), equal to its batched trial "
            f"in cycles, messages and outputs; launches a cycle "
            f"{json.dumps(single)}")
        del e
    return serial


def sweep_profile(dev, n: int, cycles: int) -> dict:
    """A twin of the sweep's engine a few cycles into its run: device ms
    and launches per batched cycle."""
    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine

    votes, _, _ = grid_votes(n, SWEEP_MARGINS, SWEEP_TRIALS, 0)
    bat = make_engine("torch", Ring.random(n, 32, seed=0), votes, seed=1,
                      batch=votes.shape[0], device=dev, capacity_per_peer=8)
    bat.step(20)
    return phase_profile(dev, bat, cycles)


def phase_batched_big(dev, n: int, batch: int, cycles: int):
    """B majority trials at n peers each, on B rings: the init storm and
    `cycles` cycles, the wheel kernels held against their plain versions
    on the first cycle, the middle one and the last. Returns the engine
    and its figures."""
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine
    from repro_torch.engine.torch_backend import SLOTS

    rng = np.random.default_rng(5)
    votes = np.stack([votes_at(n, 0.45, rng) for _ in range(batch)])
    rings = [Ring.random(n, 32, seed=5 + b) for b in range(batch)]
    peak_reset(dev)
    sync(dev)
    t0 = time.perf_counter()
    bat = make_engine("torch", rings, votes, seed=6, batch=batch, device=dev,
                      capacity_per_peer=8)
    e = bat._eng
    want = e.lanes * SLOTS * e.lane_width * e.roww * 8 / 1e9
    log(f"  reckoned wheel {want:.3f} GB a trial ({e.lanes} lanes x {SLOTS} "
        f"slots x {e.lane_width} rows x {e.roww} x 8 bytes), "
        f"{batch * want:.2f} GB for B={batch}")
    sync(dev)
    t_init = time.perf_counter() - t0
    maxes = {int(r.addrs[-1]) for r in rings}
    assert len(maxes) == batch  # every trial its own ring maximum
    chk = CycleKernelCheck(e, dev, keys=BATCHED_KEYS)
    t0 = time.perf_counter()
    half = cycles // 2
    for check, k in ((True, 1), (False, half - 1), (True, 1),
                     (False, cycles - half - 2), (True, 1)):
        if check:
            chk.restart()
        bat.step(k)
    sync(dev)
    dt = time.perf_counter() - t0 - chk.seconds
    chk.remove()
    assert len(chk.checked) == 3 and chk.complete()
    assert (bat.t == cycles).all()
    log_checks(chk, f"B={batch} n={n} on {batch} rings")
    assert (bat.dropped == 0).all(), "messages dropped"
    bat.check_conservation()
    wheel = nbytes(e._st.wheel) / 1e9
    assert abs(wheel - batch * want) < 1e-6
    peak = peak_gb(dev)
    log(f"  B={batch} n={n}: init storm {t_init:.2f} s; {cycles} cycles in "
        f"{dt:.2f} s = {cycles / dt:.1f} batched cycles/s; wheel {wheel:.2f} "
        f"GB; peak {peak:.2f} GB (the checks' clones included); dropped 0, "
        f"conservation holds")
    return bat, {"B": batch, "init_s": t_init, "cycles_per_s": cycles / dt,
                 "wheel_gb": wheel, "peak_gb": peak,
                 "kernel_checks": len(chk.checked), "check_s": chk.seconds}


# -- phase 16: the serve layer ----------------------------------------------

SERVE_GRID = (("majority", 811), ("mean", 822), ("l2", 833))


def serve_schedule(problem_name: str, seed: int, n: int) -> dict:
    """The differential harness's serve schedule for (problem, seed),
    drawn the same way (the same generator, in the same order) but at n
    peers: data, ring seed, and a `gen_workload` trace."""
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.launch.serve import gen_workload

    rng = np.random.default_rng(seed)
    rng.integers(48, 97)  # the harness's own n, replaced by `n`
    if problem_name == "majority":
        data = rng.integers(0, 2, size=n).astype(np.int64)
    elif problem_name == "mean":
        off = float(rng.choice([-0.6, 0.6]))
        data = rng.normal(off, 0.8, size=n)
    else:
        c = rng.normal(size=2)
        c *= float(rng.choice([0.2, 1.8])) / max(np.linalg.norm(c), 1e-9)
        data = rng.normal(c, 0.25, size=(n, 2))
    ring_seed = int(rng.integers(0, 2**31))
    ring = Ring.random(n, 32, seed=ring_seed)
    workload = gen_workload(
        ring, problem_name, windows=int(rng.integers(12, 19)),
        seed=seed + 3, rate=float(rng.uniform(4.0, 9.0)), p_churn=0.35,
        window_cycles=int(rng.integers(4, 9)), p_flip_sub=0.25)
    return {"problem": problem_name, "ring": ring, "eng_seed": seed + 7,
            "data": data, "workload": workload}


def phase_serve_parity(dev, n: int) -> None:
    """Each serve schedule through a ThresholdServer over the kernels-on
    engine and over the plain one: the transition stream, the outputs,
    the counters and the full state equal after every flush, and
    conservation holds."""
    import numpy as np
    from repro_torch.engine import L2Thresh, MeanMonitor, make_engine
    from repro_torch.launch.serve import ThresholdServer, replay_workload

    probs = {"majority": None, "mean": MeanMonitor(tau=0.0),
             "l2": L2Thresh(tau=1.0, dim=2)}
    for name, seed in SERVE_GRID:
        sched = serve_schedule(name, seed, n)
        w = sched["workload"]
        runs = []
        for wk in ("auto", "none"):
            eng = make_engine("torch", sched["ring"], sched["data"],
                              seed=sched["eng_seed"], device=dev,
                              capacity_per_peer=8, problem=probs[name],
                              wheel_kernels=wk)
            server = ThresholdServer(eng, window=w["window_cycles"])
            trs, snaps = [], []
            server.subscribe(lambda tr, trs=trs: trs.append(
                (tr.t, tuple(sorted(tr.peers)), tr.output)))

            def after(_i, eng=eng, snaps=snaps):
                eng.check_conservation()
                snaps.append(eng.outputs())

            replay_workload(server, w, after_pump=after)
            runs.append((eng, trs, snaps, server.stats()))
        (a, ta, pa, sa), (b, tb, pb, sb) = runs
        assert ta == tb, f"{name}: transition streams differ"
        assert sa == sb, f"{name}: counters differ"
        assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
        assert_same_state(a, b, f"after the {name} serve schedule")
        assert sa["dropped"] == 0
        log(f"  {name} (seed {seed}) n={n}: {len(w['windows'])} windows of "
            f"{w['window_cycles']} cycles, {sa['submitted']} submits, "
            f"{sum(len(x['churn']) for x in w['windows'])} churn events: "
            f"{len(ta)} transitions, outputs after every flush and the full "
            f"state equal to the plain engine's; conservation holds")


def transition_digest(tr) -> tuple:
    """One published transition as (t, output, peers, sha256 of the
    sorted peer set)."""
    peers = sorted(tr.peers)
    return (int(tr.t), int(tr.output), len(peers),
            hashlib.sha256(repr(peers).encode()).hexdigest()[:16])


def serve_bursts(server, eng, sched, occupied, addrs, rng, params,
                 within, marks) -> None:
    """The volleys of `sched` through the leading `server`: a join at a
    free address and a leave of a live one, the volley's submits, then
    pumps until the server settles (`within()` must hold meanwhile);
    after each, `marks` gets the cycle, the transitions and the settle
    records so far."""
    import numpy as np
    from repro_torch.launch.serve import _raw_value

    for tgt, vals in sched:
        while True:
            a = int(rng.integers(1, 1 << 16))
            if a not in occupied:
                break
        occupied.add(a)
        server.join(a, _raw_value("majority", rng, params))
        victim = addrs.pop(int(rng.integers(len(addrs))))
        server.leave_addr(victim)
        occupied.discard(victim)
        live = np.asarray(eng.ring.addrs)
        for i, v in zip(tgt, vals):
            server.submit(int(live[i % live.size]), v)
        server.pump()
        while not server.settled:
            server.pump()
            assert within(), "never settled"
        marks.append((int(eng.t), server.notifier.published,
                      sum(r["kind"] == "settle" for r in server.trace)))


SERVE_WARM = os.path.join(HERE, "build", "serve_warm_state.npz")


def phase_serve_load(dev, n: int, updates: int = 4000, bursts: int = 16,
                     window: int = 8, settle_cap: int = 4000,
                     mesh=None, run: int = 0, warm: str = None) -> dict:
    """Majority at n peers behind a ThresholdServer: `bursts` volleys of
    updates (drawn as `benchmarks/serve.py` draws them, submitted at
    once), a join and a leave before each, every volley pumped until
    the server settles. Updates a second, settle latencies, transitions,
    dropped. `run` of the volleys are served (all when 0: the first
    `run` of the same schedule). The engine's state once the init storm
    has settled is written to `SERVE_WARM`; with `warm` (that file) the
    engine starts from it instead (its notifier seeded with those
    outputs), skipping the storm. With `mesh` (a process group) the
    engine is the sharded one and every rank of the group calls this:
    rank 0's server takes the calls and the others follow it."""
    import numpy as np
    from repro_torch.core.dht import Ring
    from repro_torch.engine import (ShardedTorchEngine, TorchEngine,
                                    make_engine)
    from repro_torch.launch.serve import (ThresholdServer, _raw_value,
                                          settle_latencies, workload_params)

    rng = np.random.default_rng(0)
    params = workload_params("majority", rng)
    ring = Ring.random(n, 32, seed=0)
    votes = (rng.random(n) < 0.4).astype(np.int64)
    mkw = {} if mesh is None else {"mesh": mesh}
    t0 = time.perf_counter()
    if warm is None:
        eng = make_engine("torch", ring, votes, seed=1, device=dev,
                          capacity_per_peer=8, **mkw)
    else:
        with np.load(warm) as z:
            state = dict(z)
        cls = TorchEngine if mesh is None else ShardedTorchEngine
        eng = cls.from_state(ring, state, seed=1, device=dev,
                             capacity_per_peer=8, **mkw)
    server = ThresholdServer(eng, window=window)
    if warm is None:
        if server.lead:
            server.pump()
            while not server.settled:  # the init storm, off the clock
                server.pump()
            server.close()
        else:
            server.follow()
        if mesh is None:
            os.makedirs(os.path.dirname(SERVE_WARM), exist_ok=True)
            np.savez(SERVE_WARM, **eng.global_state())
    else:  # the notifier knows every peer's settled output, as after a storm
        server.notifier.publish(eng.t, np.asarray(eng.ring.addrs),
                                eng.outputs())
    t_init = time.perf_counter() - t0
    server.trace.clear()
    trs = []
    server.subscribe(lambda tr: trs.append(transition_digest(tr)))
    per = updates // bursts
    sched = [(rng.integers(0, n, per),
              [_raw_value("majority", rng, params) for _ in range(per)])
             for _ in range(bursts)][: run or bursts]
    addrs = [int(a) for a in ring.addrs]
    occupied = set(addrs)
    windows0, marks = server.windows, []
    published0 = server.notifier.published
    t0 = time.perf_counter()
    if server.lead:
        serve_bursts(server, eng, sched, occupied, addrs, rng, params,
                     lambda: server.windows - windows0 < settle_cap, marks)
        marks = [(t, k - published0, m) for t, k, m in marks]
        server.close()
    else:
        server.follow()
    sync(dev)
    elapsed = time.perf_counter() - t0
    st, lat = server.stats(), settle_latencies(server.trace)
    assert st["dropped"] == 0 and eng.dropped == 0, "messages dropped"
    eng.check_conservation()
    assert (eng.outputs() == server.truth).all()
    submitted = per * len(sched)
    rec = {"n": n, "init_s": t_init, "updates": submitted,
           "elapsed_s": elapsed,
           "updates_per_s": submitted / elapsed,
           "windows": server.windows - windows0,
           "cycles": int(eng.t), "transitions": st["transitions"],
           "applied": st["applied"], "coalesced": st["coalesced"],
           "dropped": st["dropped"], **lat,
           "settle_cycles": [r["cycles"] for r in server.trace
                             if r["kind"] == "settle"],
           "settle_ms": [r["wall_ms"] for r in server.trace
                         if r["kind"] == "settle"],
           "transition_digests": trs, "burst_marks": marks}
    if mesh is not None:
        return rec
    q = lambda unit: "/".join(
        "-" if lat[f"{unit}_{k}"] is None else f"{lat[f'{unit}_{k}']:.1f}"
        for k in ("p50", "p95", "max"))
    log(f"  majority n={n}, window {window}: {rec['updates']} updates in "
        f"{len(sched)} bursts with a join and a leave each, {elapsed:.2f} s "
        f"= {rec['updates_per_s']:.0f} updates/s over {rec['windows']} "
        f"windows; settle latency p50/p95/max {q('cycles')} cycles, "
        f"{q('ms')} ms ({lat['decisions']} settles); {st['transitions']} "
        f"transitions; dropped 0")
    return rec


# -- phase 17: the sharded engine on the card ---------------------------------

SHARD_WORLDS = (1, 2, 4)
WHEEL_PER_CYCLE = ("stage_rows", "threshold_step", "due_dedup", "descent_tail")


def shard_cells(world: int):
    """Phase 17's parity cells at `world` ranks: majority through a data
    flip and 8 churn events everywhere; at world 2 also mean and L2, the
    majority engine without the threshold kernel, the plain majority
    engine, and the first fault schedule armed."""
    return ("majority",) + (("mean", "l2", "majority_no_threshold",
                             "majority_plain", "armed") if world == 2
                            else ())


def shard_cell_run(cell: str, dev, **mesh) -> list:
    """Cell `cell` on one engine with `mesh` passed to `make_engine`:
    phase 3's churn script on its churn cell (kernels-on; every plain
    version for "majority_plain"), or for "armed" phase 12's script of
    the first fault schedule, kernels-on. Returns the state digest (for
    "armed" the `fault_digest`) at each of the script's checks."""
    out = []
    if cell == "armed":
        sched = fault_schedule(*FAULT_GRID[0])
        eng = fault_engine(sched, dev, "auto", **mesh)
        fault_script((eng,), sched, lambda _: out.append(fault_digest(eng)))
        eng.check_conservation()
    else:
        eng, new = churn_cell(cell.replace("_plain", ""), dev,
                              cell.endswith("_plain"), **mesh)
        churn_script((eng,), new, lambda _: out.append(snapshot(eng)))
    return out


def rank_profile(eng, dev, cycles: int) -> dict:
    """Device ms and launches a cycle of this rank over `cycles` cycles
    (`device_events` after a 2-cycle warm-up). Every rank profiles the
    same calls; a session with fewer device events than this rank's
    counted launches is refused on every rank (one all-reduce) and all
    profile again, at most three times."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.wheel import LAUNCHES

    for _ in range(3):
        k0 = {}
        wall, ev = device_events(
            dev, lambda: (k0.update(LAUNCHES), eng.step(cycles)),
            warmup=lambda: eng.step(2), cpu=False)
        counted = sum(v - k0[k] for k, v in LAUNCHES.items())
        dev_us = sum(e.self_device_time_total for e in ev)
        launches = sum(e.count for e in ev)
        bad = torch.tensor([int(dev.type == "cuda" and (
            dev_us <= 0 or launches < counted))], device=dev)
        dist.all_reduce(bad, group=eng.group)
        if not int(bad):
            break
    else:
        raise RuntimeError("three profiles of the sharded cycle dropped "
                           "events")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    return {"device_ms_per_cycle": dev_us / 1e3 / cycles,
            "launches_per_cycle": launches / cycles,
            "wall_ms_per_cycle": wall * 1e3 / cycles,
            "top": [(e.key[:90], e.self_device_time_total / cycles,
                     e.count / cycles) for e in top]}


def exchange_cost(eng, dev, iters: int = 20) -> dict:
    """The cycle's boundary exchange alone at the cycle's shape (every
    lane's 4 window_l staged rows, disarmed): host ms a call around
    synchronized calls, the bytes each rank sends (its lanes' packet,
    32-bit columns plus the meta column) and the bytes each receives
    (every rank's)."""
    import torch

    L, rows, roww = eng.loc_lanes, 4 * eng.window_l, eng.roww
    blk = (torch.zeros((L, rows, roww), dtype=torch.int64, device=dev),
           torch.ones((L, rows), dtype=torch.bool, device=dev),
           torch.zeros((L, rows), dtype=torch.bool, device=dev))
    for _ in range(3):
        eng._plane.exchange(blk)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        eng._plane.exchange(blk)
    sync(dev)
    sent = L * rows * (roww + 1) * 4
    return {"ms": (time.perf_counter() - t0) * 1e3 / iters,
            "bytes_sent": sent, "bytes_gathered": sent * eng.n_shards}


def shard_converge(dev, n: int, group) -> dict:
    """Phase 4 on the sharded engine at n peers (1e5), converge at mu = 0.45,
    flip to 0.55 through `apply_coalesced`, converge again; the wheel
    kernels held exactly against their plain versions on the first cycle
    and on each cycle whose descent batch is 1.5 times the widest checked
    (`CycleKernelCheck`, its host time left out of the rate); then 10
    cycles with every wheel kernel launched once a cycle, a profile of 10
    cycles and the exchange alone."""
    from repro_torch.kernels.wheel import launch_counts

    eng, votes, rng = make(n, dev, seed=3, mu=0.45, mesh=group)
    chk = CycleKernelCheck(eng, dev, keys=("_descent", "_dedup", "_thresh",
                                           "_stage"))
    chk.restart()
    out = {}
    for stage, mu in ((1, None), (2, 0.55)):
        if mu is not None:
            new = votes_at(n, mu, rng)
            chg = (new != eng.votes()).nonzero()[0]
            eng.apply_coalesced(chg, new[chg])
            votes = new
        truth = int(2 * votes.sum() >= n)
        sync(dev)
        t0, c0, s0 = time.perf_counter(), eng.t, chk.seconds
        res = eng.run_until_converged(truth=truth, max_cycles=20_000)
        sync(dev)
        dt = time.perf_counter() - t0 - (chk.seconds - s0)
        assert res["converged"] == 1.0 and eng.dropped == 0
        eng.check_conservation()
        assert (eng.outputs() == truth).all()
        out[f"stage{stage}"] = dict(cycles=eng.t - c0,
                                    messages=res["messages"],
                                    cycles_per_s=(eng.t - c0) / dt)
    chk.remove()
    assert chk.complete(), chk.checked
    out["checked"] = chk.checked
    c0 = launch_counts()
    eng.step(10)
    per = {k: v - c0[k] for k, v in launch_counts().items()}
    if dev.type == "cuda":  # the CPU runs the plain versions
        assert all(per[k] == 10 for k in WHEEL_PER_CYCLE), per
    out["launches_10_cycles"] = {k: per[k] for k in WHEEL_PER_CYCLE}
    out["profile"] = rank_profile(eng, dev, 10)
    out["exchange"] = exchange_cost(eng, dev)
    return out


def shard_big(dev, n: int, group) -> dict:
    """Phase 5 on the sharded engine at n peers (1e6): the init storm and 100
    cycles; the outputs, the counters and each state field's digest, and
    a profile of 10 cycles."""
    import hashlib

    sync(dev)
    t0 = time.perf_counter()
    eng, _, _ = make(n, dev, seed=5, mu=0.45, mesh=group)
    sync(dev)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.step(100)
    sync(dev)
    dt = time.perf_counter() - t0
    rec = {"init_s": t_init, "cycles_per_s": 100 / dt,
           "digest": snapshot(eng), "counters": big_counters(eng),
           "outputs": hashlib.sha256(eng.outputs().tobytes()).hexdigest()}
    rec["profile"] = rank_profile(eng, dev, 10)
    rec["exchange"] = exchange_cost(eng, dev, iters=10)
    return rec


def big_counters(eng) -> dict:
    return {"t": eng.t, "messages": eng.messages_sent,
            "in_flight": eng.in_flight, "deferred": eng.deferred,
            "dropped": eng.dropped, **eng.check_conservation()}


def shard_rank(dev, group, world: int, n_mid: int, n_big: int) -> dict:
    """Phase 17 on one rank of `group` (`world` ranks): the parity cells of
    `world`, phase 4 at n_mid peers, and unless `n_big` is 0 phase 5 at
    n_big; the rank's launch counts and its wall time."""
    from repro_torch.kernels.wheel import launch_counts, reset_launches

    t0 = time.perf_counter()
    reset_launches()
    out = {"cells": {c: shard_cell_run(c, dev, mesh=group)
                     for c in shard_cells(world)}}
    out["mid"] = shard_converge(dev, n_mid, group)
    if n_big:
        out["big"] = shard_big(dev, n_big, group)
    sync(dev)
    out["launches"] = launch_counts()
    out["wall_s"] = time.perf_counter() - t0
    return out


def shard_job(rank: int, world: int, dev, worlds, n_mid: int,
              n_big: int, serve_bursts: int) -> dict:
    """One rank of a spawned job of `world` ranks: for each world size w
    of `worlds`, `shard_rank` on the job's first w ranks (the whole job,
    or a `dist.new_group` of them on the job's backend; the other ranks
    wait at a barrier), phase 5 at world 1 only; then the control plane
    on the same groups (`control_rank`). Returns {w: this rank's record}
    for the worlds it took part in, and "control"."""
    import torch.distributed as dist

    out, groups = {}, {}
    for w in worlds:
        groups[w] = (dist.group.WORLD if w == world
                     else dist.new_group(list(range(w))))
        if rank < w:
            out[w] = shard_rank(dev, groups[w], w, n_mid,
                                n_big if w == 1 else 0)
        dist.barrier()
    out["control"] = control_rank(rank, dev, groups, n_mid, serve_bursts)
    return out


# tree collectives on the card: the dtypes, and the sizes timed
TREE_DTYPES = ("float32", "bfloat16", "int64")
TREE_TIMED = ((4, 20), (64 << 20, 2))  # (bytes, calls)


def tree_inputs(p: int, numel: int = 4099) -> dict:
    """Every rank's input of each dtype on the host, drawn from its rank:
    float32 over eight decades (the order of additions shows), bfloat16
    rounded from it, int64 up to 2^40."""
    import numpy as np
    import torch

    out = {k: [] for k in TREE_DTYPES}
    for r in range(p):
        rng = np.random.default_rng(1000 + r)
        f = (rng.standard_normal(numel)
             * 10.0 ** rng.uniform(-4, 4, numel)).astype(np.float32)
        out["float32"].append(torch.from_numpy(f))
        out["bfloat16"].append(torch.from_numpy(f).to(torch.bfloat16))
        out["int64"].append(torch.from_numpy(
            rng.integers(-2**40, 2**40, numel)))
    return out


def bits(t):
    """A tensor's bit patterns (floats compared bit for bit)."""
    import torch

    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(as_int[t.dtype]) if t.dtype in as_int else t


def tree_check(dev, group) -> dict:
    """`core.tree_collectives` on `group` with tensors on `dev`: each of
    `tree_reduce`, `tree_broadcast` and `tree_all_reduce` on every dtype
    of `tree_inputs`, bit-identical to the host replay of the reference's
    schedule (`schedule_replay`) for this rank; then the ms of a 4-byte
    and a 64 MiB float32 `tree_all_reduce` beside `dist.all_reduce` on
    the same group (host clock around synchronized calls, after a
    barrier)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import tree_collectives as T

    p, rank = dist.get_world_size(group), dist.get_rank(group)
    xs = tree_inputs(p)
    for name in TREE_DTYPES:
        x = xs[name][rank].to(dev)
        for op, fn in (("reduce", T.tree_reduce),
                       ("broadcast", T.tree_broadcast),
                       ("all_reduce", T.tree_all_reduce)):
            got = fn(x, group).cpu()
            want = T.schedule_replay(xs[name], op)[rank]
            assert got.dtype == want.dtype and torch.equal(
                bits(got), bits(want)), (p, name, op, rank)
    ms = {}
    for nb, calls in TREE_TIMED:
        x = torch.ones(nb // 4, dtype=torch.float32, device=dev)
        for what, fn in (("tree", lambda: T.tree_all_reduce(x, group)),
                         ("all_reduce", lambda: dist.all_reduce(
                             x.clone(), group=group))):
            fn()
            sync(dev)
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync(dev)
            ms[f"{what}_{nb}B"] = (time.perf_counter() - t0) * 1e3 / calls
    return {"p": p, "backend": dist.get_backend(group), "exact": True,
            "device": str(dev), "ms": ms}


def resize_drill(dev, sizes=(2, 4, 1, 4)) -> dict:
    """Phase 3's majority churn cell on the sharded engine of the whole
    job, re-partitioned after every second of the script's checks to the
    next of `sizes` ranks in turn (4 -> 2 -> 4 -> 1 -> 4 ...): every rank
    calls `resize_mesh`, the others drive the script only while they
    hold lanes. Returns the digests taken at the checks (rank 0 holds
    lanes throughout) and the sizes."""
    import itertools

    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.churn import random_schedule

    eng, new = churn_cell("majority", dev, mesh=dist.group.WORLD)
    ring0, order, seen, digests = eng.ring, itertools.cycle(sizes), [], []
    checks = [0]  # counted on every rank, lanes or not
    act = lambda f: f() if eng.active else None

    def check():
        if eng.active:
            digests.append(snapshot(eng))
        checks[0] += 1
        if checks[0] % 2:
            seen.append(next(order))
            eng.resize_mesh(seen[-1])

    t0 = time.perf_counter()
    act(lambda: eng.step(60))
    check()
    act(lambda: eng.apply_coalesced(np.arange(new.shape[0]), new))
    check()
    sched = random_schedule(ring0, 8, seed=13, spacing=20)
    for op, gap in zip(sched.ops, sched.gaps):
        act(lambda: eng.join(op[1], vote=op[2]) if op[0] == "join"
            else eng.leave(op[1]))
        check()
        act(lambda: eng.step(int(gap)))
        check()
    if eng.active:
        assert eng.dropped == 0
        eng.check_conservation()
    return {"digests": digests, "sizes": seen,
            "seconds": time.perf_counter() - t0}


def control_rank(rank: int, dev, groups: dict, n_mid: int,
                 serve_bursts: int) -> dict:
    """The control plane on one rank of a phase-17 job: tree collectives
    on each of the job's groups; phase 16's serve load over the sharded
    engine of each group (the first `serve_bursts` of its 16 volleys, all
    when 0; the ranks outside wait at a barrier); at 4 ranks the resize
    drill.
    The wheel kernels' launches of all of it are counted."""
    import torch.distributed as dist
    from repro_torch.kernels.wheel import launch_counts, reset_launches

    reset_launches()
    out = {"tree": {}, "serve": {}}
    t0 = time.perf_counter()
    for w, group in groups.items():
        if rank < w:
            out["tree"][w] = tree_check(dev, group)
        dist.barrier()
    t1 = time.perf_counter()
    for w, group in groups.items():
        if rank < w:
            out["serve"][w] = phase_serve_load(dev, n_mid, mesh=group,
                                               run=serve_bursts,
                                               warm=SERVE_WARM)
        dist.barrier()
    t2 = time.perf_counter()
    if dist.get_world_size() == 4:
        out["resize"] = resize_drill(dev)
    sync(dev)
    out["seconds"] = {"tree": t1 - t0, "serve": t2 - t1,
                      "resize": time.perf_counter() - t2}
    out["launches"] = launch_counts()
    return out


def log_top(prof: dict) -> None:
    """Rank 0's largest device events a cycle, from `rank_profile`."""
    for key, us, count in prof["top"]:
        log(f"    {us:9.1f} us/cycle {count:5.1f}x  {key}")


# the volleys of phase 16's 16 that each world of 2 or more ranks serves on
# the sharded engine (compared with phase 16's first ones); world 1 serves
# all 16. Gloo ranks sharing the card serve a burst in 4.5-6 s (PERF.md §6)
SERVE_BURSTS_MULTI = 2


SETTLES_FOR_P95 = 10  # fewer settles print each one, not a tail


def check_control(world_ctl: list, backend: str, serve_ref: dict,
                  want: list, launches: dict) -> dict:
    """Phase 17's control plane from one job's ranks (`control_rank`):
    the tree collectives exact on every rank of every group, each
    world's sharded serve equal to phase 16's run over the same volleys
    (transitions, settle cycles and the cycle count at the end), the
    resize drill's digests equal to phase 3's; logs the figures and adds
    the ranks' launches to `launches`. Returns the record."""
    rec = {}
    for ctl in world_ctl:
        for k, v in ctl["launches"].items():
            launches[k] = launches.get(k, 0) + v
    r0 = world_ctl[0]
    for w, tr in r0["tree"].items():
        assert all(c["tree"][w]["exact"] for c in world_ctl[:w])
        rec[f"tree_P{w}"] = tr
        ms = tr["ms"]
        staged = tr["backend"] == "gloo" and "cuda" in tr["device"]
        log(f"  tree collectives P={w} ({tr['backend']}, tensors on "
            f"{tr['device']}{', staged through the host for send/recv' if staged else ''}): "
            f"tree_reduce / tree_broadcast / tree_all_reduce of float32, "
            f"bfloat16 and int64 equal bit for bit on every rank to the host "
            f"replay of the reference's schedule; tree_all_reduce 4 B "
            f"{ms['tree_4B']:.3f} ms, 64 MiB {ms[f'tree_{64 << 20}B']:.2f} ms; "
            f"dist.all_reduce 4 B {ms['all_reduce_4B']:.3f} ms, 64 MiB "
            f"{ms[f'all_reduce_{64 << 20}B']:.2f} ms")
    for w, sv in r0["serve"].items():
        runs = len(sv["burst_marks"])
        t_end, n_tr, n_set = serve_ref["burst_marks"][runs - 1]
        assert sv["transition_digests"] == \
            serve_ref["transition_digests"][:n_tr], (w, "transitions")
        assert sv["settle_cycles"] == serve_ref["settle_cycles"][:n_set], (
            w, "settle cycles")
        assert sv["cycles"] == t_end and sv["burst_marks"] == \
            serve_ref["burst_marks"][:runs], (w, "cycles")
        for c in world_ctl[1:w]:
            assert c["serve"][w]["cycles"] == sv["cycles"]
            assert c["serve"][w]["transition_digests"] == \
                sv["transition_digests"]
        tail = n_set >= SETTLES_FOR_P95  # else each settle, not a tail
        rec[f"serve_world{w}"] = {k: v for k, v in sv.items() if k not in (
            "transition_digests", "burst_marks", "settle_cycles",
            "settle_ms") and (tail or not k.startswith(("cycles_p", "ms_p")))}
        lat = (f"settle p50/p95/max {sv['cycles_p50']:.0f} / "
               f"{sv['cycles_p95']:.0f} / {sv['cycles_max']:.0f} cycles, "
               f"{sv['ms_p50']:.1f} / {sv['ms_p95']:.1f} / "
               f"{sv['ms_max']:.1f} ms" if tail else "settles " + ", ".join(
                   f"{c} cycles in {m:.1f} ms" for c, m in
                   zip(sv["settle_cycles"], sv["settle_ms"])))
        log(f"  sharded serve world {w} ({backend}), n={sv['n']}: "
            f"{'all' if runs == 16 else f'the first {runs}'} of phase 16's "
            f"16 bursts ({sv['updates']} updates, a join and a leave each), "
            f"{sv['elapsed_s']:.2f} s = {sv['updates_per_s']:.1f} updates/s "
            f"over {sv['windows']} windows; {lat}; {n_tr} transitions and "
            f"{n_set} settle cycles equal to phase 16's on every rank, "
            f"t={sv['cycles']}")
    sec = r0["seconds"]
    rec["control_seconds"] = sec
    log(f"  the control plane on rank 0 of the {backend} job: "
        f"{sum(sec.values()):.1f} s (tree collectives {sec['tree']:.1f}, "
        f"serving {sec['serve']:.1f}, resize {sec['resize']:.1f})")
    if "resize" in r0:
        rz = r0["resize"]
        assert rz["digests"] == want, "the resized engine's state differs"
        rec["resize"] = {"sizes": rz["sizes"], "checks": len(rz["digests"]),
                         "seconds": rz["seconds"]}
        log(f"  resize_mesh through phase 3's majority churn cell, "
            f"re-partitioned after every second of its "
            f"{len(rz['digests'])} checks "
            f"({' -> '.join(map(str, [4] + rz['sizes']))} ranks): the "
            f"gathered state equal to phase 3's kernels-on digests at every "
            f"check; {rz['seconds']:.1f} s")
    return rec


def phase_sharded(dev, conv: dict, big_ref: dict, want: dict,
                  serve_ref: dict, n_mid: int = N_MID,
                  n_big: int = N_BIG) -> tuple:
    """Phase 17. World 1 on NCCL, then worlds 2 and 4 on gloo (every rank
    on this card, one spawned job of 4 ranks, world 2 on its first two)
    run `shard_rank`: every rank gathers the same state, and each cell's
    digests equal `want`'s, the kernels-on single engine's of phases 3
    and 12, held there against the plain engine at every check; the 1e5
    stage cycles equal phase 4's; at world 1 the 1e6 state, outputs and
    counters equal phase 5's. Returns (the record, the path's launches
    summed over every rank)."""
    want = dict(want, majority_plain=want["majority"])
    import torch
    from repro_torch.launch.mesh import spawn

    rec, launches = {}, {}
    # NCCL takes one rank a card: more ranks on this card go on gloo
    jobs = (("nccl" if dev.type == "cuda" else "gloo", (1,)),
            ("gloo", tuple(w for w in SHARD_WORLDS if w > 1)))
    for backend, worlds in jobs:
        bursts = SERVE_BURSTS_MULTI if max(worlds) > 1 else 0
        job = spawn(shard_job, max(worlds), backend, str(dev), worlds,
                    n_mid, n_big, bursts, timeout=900)
        rec.update(check_control([g["control"] for g in job], backend,
                                 serve_ref, want["majority"], launches))
        for world in worlds:
            got = [g[world] for g in job[:world]]
            r0 = got[0]
            for r, g in enumerate(got):
                assert g["cells"] == r0["cells"], (
                    f"world {world}: rank {r} gathered another state than "
                    f"rank 0")
            for cell, digests in r0["cells"].items():
                assert digests == want[cell], (
                    f"world {world} cell {cell}: the sharded state differs "
                    f"from the single engine's")
            for g in got:
                for k, v in g["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            mid = r0["mid"]
            stages = sorted(k for k in mid if k.startswith("stage"))
            for st in stages:
                assert mid[st]["cycles"] == conv[st]["cycles"], (world, st)
                assert all(g["mid"][st]["cycles"] == mid[st]["cycles"]
                           for g in got)
            for r, g in enumerate(got):
                assert dev.type != "cuda" or g["mid"]["launches_10_cycles"] \
                    == {k: 10 for k in WHEEL_PER_CYCLE}, (world, r)
            rec[f"world{world}"] = {
                "backend": backend, "ranks_on": str(dev),
                "wall_s": r0["wall_s"], "cells": sorted(r0["cells"]),
                "n_1e5": {k: v for k, v in mid.items() if k != "checked"},
                "checked_cycles": len(mid["checked"])}
            log(f"  world {world} ({backend}, {world} rank(s) on {dev}): "
                f"cells {', '.join(sorted(r0['cells']))} equal on every rank "
                f"to the kernels-on single engine of phases 3 and 12 (itself "
                f"equal to the plain one) in full state at each of their "
                f"checks; n={n_mid} "
                + ", ".join(f"{st} {mid[st]['cycles']} cycles (phase 4: "
                            f"{conv[st]['cycles']}) at "
                            f"{mid[st]['cycles_per_s']:.1f} cycles/s"
                            for st in stages) + "; rank 0 "
                f"{mid['profile']['device_ms_per_cycle']:.3f} ms device a "
                f"cycle in {mid['profile']['launches_per_cycle']:.0f} "
                f"launches; the exchange {mid['exchange']['ms']:.3f} ms, "
                f"{mid['exchange']['bytes_gathered']:,} bytes gathered a "
                f"cycle; each wheel kernel 10 launches in 10 cycles on every "
                f"rank; {r0['wall_s']:.1f} s on rank 0")
            log_top(mid["profile"])
            if world == 1:
                b = r0["big"]
                assert b["digest"] == big_ref["digest"], (
                    "the 1e6 sharded state differs from phase 5's")
                assert b["counters"] == big_ref["counters"]
                assert b["outputs"] == big_ref["outputs"]
                rec["world1"]["n_1e6"] = {k: v for k, v in b.items()
                                          if k != "digest"}
                log(f"  world 1 n={n_big}: init storm {b['init_s']:.2f} s, "
                    f"100 cycles at {b['cycles_per_s']:.1f} cycles/s; state "
                    f"(every field's sha256), outputs and counters equal to "
                    f"phase 5's engine; {b['profile']['device_ms_per_cycle']:.3f}"
                    f" ms device a cycle in "
                    f"{b['profile']['launches_per_cycle']:.0f} launches "
                    f"(phase 5: {big_ref['device_ms_per_cycle']:.3f}); the "
                    f"exchange {b['exchange']['ms']:.3f} ms, "
                    f"{b['exchange']['bytes_gathered']:,} bytes")
                log_top(b["profile"])
    cards = torch.cuda.device_count()
    if dev.type == "cuda" and cards >= 2:
        world = 4 if cards >= 4 else 2
        got = spawn(shard_job, world, "nccl", None, (world,), n_mid, 0,
                    SERVE_BURSTS_MULTI, timeout=900)
        for cell, digests in got[0][world]["cells"].items():
            assert digests == want[cell], (world, cell)
        mid = got[0][world]["mid"]
        rec[f"nccl_world{world}"] = {k: v for k, v in mid.items()
                                     if k != "checked"}
        log(f"  NCCL world {world}, one card a rank: equal, "
            f"{mid['stage1']['cycles_per_s']:.1f} cycles/s")
    else:
        log(f"  NCCL at world 2 or 4 not run: it needs one card a rank and "
            f"this machine has {cards}")
    return rec, launches


# -- phase 19: LM prefill and cached decode -----------------------------------

# (arch, depth (None: the full config), batch, prompt tokens, decode steps,
# frontend embeddings a row (0: none; else the config's n_frontend_tokens))
SERVE_CELLS = (("gemma-7b", None, 4, 2048, 64, 0),
               ("recurrentgemma-9b", 3, 1, 4096, 32, 0),
               ("minicpm-2b", None, 4, 2048, 16, 0),
               ("command-r-35b", 4, 2, 2048, 16, 0),
               # 30 s of audio (Whisper's fixed window) a row; the cache's
               # 192 positions stay under its 448-token text context
               ("whisper-large-v3", None, 8, 128, 64, 1500),
               ("llama-3.2-vision-11b", None, 4, 2048, 32, 4100),
               # the 3 leading dense layers and 1 MoE layer of 61 (one
               # MoE layer is 22.6 GB of bf16 weights); 15.1 B params
               ("deepseek-v3-671b", 4, 4, 2048, 32, 0),
               # 2 'dense_moe' layers of 35 (27.2 GB each); 27.7 B params
               ("arctic-480b", 2, 4, 2048, 32, 0),
               # full depth (24 blocks, 0.50 B params): the chunkwise mLSTM
               # and the sLSTM scan at prefill, their recurrent forms at
               # decode; no kernel on this path
               ("xlstm-350m", None, 4, 2048, 32, 0))
# flash_attention_fwd at the serving cells' prefill shapes: (B, Hq, Hkv,
# Sq, D, window) causal with Skv = Sq, or (B, Hq, Hkv, Sq, D, window, Skv,
# causal); D is an int, or (Dqk, Dv) for a value width unlike the key's
SERVE_FLASH = (("gemma_7b", (4, 16, 16, 2048, 256, None)),
               ("minicpm_2b", (4, 36, 36, 2048, 64, None)),
               ("command_r_35b", (2, 64, 8, 2048, 128, None)),
               ("whisper_encoder", (8, 20, 20, 1500, 64, None, 1500, False)),
               ("whisper_cross", (8, 20, 20, 128, 64, None, 1500, False)),
               ("whisper_decoder", (8, 20, 20, 128, 64, None)),
               ("llama_vision_cross",
                (4, 32, 8, 2048, 128, None, 4100, False)),
               ("deepseek_mla", (4, 128, 128, 2048, (192, 128), None)),
               ("arctic", (4, 56, 8, 2048, 128, None)))
# the gate of every gated cross-attention block: `init_params` (as the
# reference's) makes it 0, and tanh(0) = 0 would take the block out
SERVE_GATE = 1.0
SERVE_BOUND = 2e-2  # max |a - b| / max |b|: logits and cache tensors, bf16


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


class BlockRecord:
    """While active, keeps every block call's input and output x (`ins`,
    `outs`), the cache it returned (`caches`) and its other arguments
    (`calls`: block, params, positions, prefill_len, memory), in the
    order the model applies the blocks: an encoder's first, then the
    decoder's, which hold the memory (the encoder's output) of that run
    (wraps `models.model._apply_block`). With `attend`, every block runs
    it in `flash_attention_fwd`'s place (the block's own argument)."""

    def __init__(self, attend=None):
        self.attend = attend

    def __enter__(self):
        from repro_torch.models import model as M

        self._m, self._real = M, M._apply_block
        self.ins, self.outs, self.caches, self.calls = [], [], [], []

        def keep(bd, p, x, cfg, positions, cache=None, cache_pos=None,
                 prefill_len=None, memory=None):
            y, c = self._real(bd, p, x, cfg, positions, cache, cache_pos,
                              prefill_len, memory=memory, attend=self.attend)
            self.ins.append(x)
            self.outs.append(y)
            self.caches.append(c)
            self.calls.append((bd, p, positions, prefill_len, memory))
            return y, c

        M._apply_block = keep
        return self

    def __exit__(self, *exc):
        self._m._apply_block = self._real


def encoder_blocks(cfg) -> int:
    """How many encoder blocks a forward applies before the decoder's."""
    return sum(len(pat) * n for pat, n in cfg.enc_segments())


def model_blocks(cfg, segments):
    """(BlockDef, block tree) of every block of `segments` (params' or a
    cache's), in the order the model applies them."""
    return [(bd, t) for (pat, _), seg in zip(cfg.segments(), segments)
            for period in seg for bd, t in zip(pat, period)]


def first_parting(outs_a, outs_b, pick_a, pick_b, bound: float):
    """(block index, error) of the first block whose outputs, picked by
    `pick_a` / `pick_b`, differ by more than `bound`; None if none."""
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        err = rel_err(pick_a(a), pick_b(b))
        if err > bound:
            return i, err
    return None


def sdpa_attention(q, k, v, causal=True, window=None, scale=None,
                   q_offset=0):
    """`scaled_dot_product_attention` in `flash_attention_fwd`'s place
    (its o, and a dummy lse): the library's rounding, for the floor of
    an end-to-end comparison."""
    import torch
    import torch.nn.functional as Fn

    assert q_offset == 0
    o = Fn.scaled_dot_product_attention(q, k, v, scale=scale,
                                        **sdpa_args(q, causal, window))
    return o, torch.zeros(q.shape[:3], device=q.device)


def recorded_prefill(params, cfg, tokens, cache_len: int, fe=None,
                     attention=None):
    """A prefill (with frontend embeddings `fe`) with every block's call
    recorded; with `attention`, that stands in for `flash_attention_fwd`.
    Returns (the record, last-position logits, the cache)."""
    from repro_torch.models import model as M

    with BlockRecord(attention) as rec:
        logits, cache = M.forward(params, cfg, tokens, fe, mode="prefill",
                                  cache_len=cache_len)
    last = logits[:, -1].clone()
    return rec, last, cache


MOE_FFNS = ("moe", "dense_moe")
# a MoE block's lockstep at prefill: the share of its tokens that pick
# another top-k set with the kernels than with their plain versions may
# be at most this many times the share that SDPA in the kernel's place
# flips on the same input. A bf16 router is discontinuous: any rounding
# difference in its input flips the tokens whose k-th and (k+1)-th
# logits lie within it. On an NVIDIA H100 80GB HBM3 at 700 W the kernel
# and SDPA flip 1.9897 % and 1.9043 % of DeepSeek-V3's 8,192 tokens
# (top-8 of 256), Arctic's 1.1719 % and 1.2085 %, 0.5737 % and 0.5615 %
# (top-2 of 128): ratios 1.045, 0.970, 1.022
MOE_FLIP_RATIO = 1.25
# at a decode step, how many of the batch's tokens may pick another
# top-k set than the train forward's routing of the same tokens (a few
# tokens cannot resolve a share of ~2 %)
MOE_DECODE_FLIPS = 1


def block_parts(bd, pp, x, cfg, pos, cache=None, cache_pos=None,
                prefill_len=None, attend=None):
    """The model's block (`_apply_block`) on x with its parts kept:
    (the parts: its mixer's output, the FFN's normed input and output,
    a MoE's experts and kept pairs; its cache)."""
    from repro_torch.models import model as M

    parts = {}
    _, c = M._apply_block(bd, pp, x, cfg, pos, cache, cache_pos,
                          prefill_len, attend=attend, parts=parts)
    return parts, c


def moe_lockstep(a: dict, b: dict) -> dict:
    """Two runs of a MoE block over the same tokens, each its parts
    (`block_parts`): the mixer's relative error; the FFN's on the tokens
    whose experts (in order) and kept pairs agree; the tokens whose top-k
    set differs (a share and a count); each run's share of dropped
    (token, slot) pairs."""
    ea, eb, ka, kb = (t.reshape(-1, t.shape[-1]) for t in (
        a["experts"], b["experts"], a["keep"], b["keep"]))
    agree = (ea == eb).all(-1) & (ka == kb).all(-1)
    flat = lambda f: f.reshape(-1, f.shape[-1])
    n = int(agree.sum())
    flipped = (ea.sort(-1).values != eb.sort(-1).values).any(-1)
    return {"mixer": rel_err(a["mixer"], b["mixer"]),
            "ffn_agreeing": rel_err(flat(a["ffn"])[agree],
                                    flat(b["ffn"])[agree]) if n else None,
            "topk_set_differs": float(flipped.float().mean()),
            "flipped_tokens": int(flipped.sum()),
            "tokens": agree.numel(), "agreeing_tokens": n,
            "dropped": 1.0 - float(ka.float().mean()),
            "dropped_other": 1.0 - float(kb.float().mean())}


def moe_bound_err(rec: dict) -> float:
    """The error a MoE block's lockstep holds to SERVE_BOUND: its mixer's
    and its FFN's on the agreeing tokens, of which there must be one."""
    assert rec["agreeing_tokens"], (
        f"a MoE block's FFN was compared on no token: no token's routing "
        f"agrees ({rec})")
    return max(rec["mixer"], rec["ffn_agreeing"])


def lockstep_prefill(cfg, rec):
    """Each block with `cfg`'s kernels, fed the input (and a decoder
    block the memory) that block had in the recorded (plain) prefill, an
    encoder's blocks too: the larger relative error of its output and of
    each of its cache tensors against that run's, block by block. A MoE
    block runs with the kernels, with their plain versions and with SDPA
    in the kernel's place on that input, its parts kept (`block_parts`):
    its error is its mixer's (and cache's) and its FFN's on the tokens
    whose routing agrees, and its `moe_lockstep` records are kept (the
    SDPA run's under "sdpa", the yardstick of the routing's flips).
    Returns (errors, {block index: MoE record})."""
    import dataclasses

    from repro_torch.models import model as M

    plain = dataclasses.replace(cfg, use_kernels=False)
    errs, moe = [], {}
    for i, (x, want, want_c, (bd, pp, pos, plen, mem)) in enumerate(zip(
            rec.ins, rec.outs, rec.caches, rec.calls)):
        if bd.ffn in MOE_FFNS:
            (got, c), (want, want_c) = (
                block_parts(bd, pp, x, k, pos, prefill_len=plen)
                for k in (cfg, plain))
            lib, _ = block_parts(bd, pp, x, cfg, pos, attend=sdpa_attention)
            moe[i] = dict(moe_lockstep(got, want),
                          sdpa=moe_lockstep(lib, want))
            caches = zip(_leaves(c), _leaves(want_c))
            errs.append(max([moe_bound_err(moe[i])]
                            + [rel_err(a, b) for a, b in caches]))
            continue
        y, c = M._apply_block(bd, pp, x, cfg, pos, prefill_len=plen,
                              memory=mem)
        caches = [] if want_c is None else zip(_leaves(c), _leaves(want_c))
        errs.append(max([rel_err(y, want)] + [rel_err(a, b)
                                              for a, b in caches]))
    return errs, moe


def lockstep_decode(cfg, rec, at: int, cache_len: int):
    """Each decoder block's decode at position `at`, against the recorded
    train forward: the block builds its cache by a prefill over the input
    (and the memory) it had there at positions < at, then decodes its
    input at `at`; the relative error against that forward's output at
    `at`, block by block. A MoE block's decode is compared by its parts
    (`moe_lockstep`): its mixer against the forward's mixer at `at`, its
    FFN against the forward's FFN run again on the forward's FFN input at
    `at` alone, the same B tokens and so the same capacity as the
    decode's (the forward's own capacity counts every token of it).
    Returns (errors, {block index: MoE record})."""
    import torch
    from repro_torch.models import model as M

    dev = rec.ins[0].device
    here = torch.tensor(at, dtype=torch.int32, device=dev)
    errs, moe = [], {}
    n_enc = encoder_blocks(cfg)
    for i, (x, want, (bd, pp, pos, _, mem)) in enumerate(zip(
            rec.ins[n_enc:], rec.outs[n_enc:], rec.calls[n_enc:])):
        _, c = M._apply_block(bd, pp, x[:, :at], cfg, pos[:at],
                              prefill_len=cache_len, memory=mem)
        if bd.ffn in MOE_FFNS:
            dec, _ = block_parts(bd, pp, x[:, at:at + 1], cfg, here[None], c,
                                 here)
            full, _ = block_parts(bd, pp, x, cfg, pos)
            ref = {"mixer": full["mixer"][:, at:at + 1]}
            ref["ffn"] = M._ffn(bd, pp, full["ffn_in"][:, at:at + 1], cfg,
                                ref)
            moe[i] = moe_lockstep(dec, ref)
            errs.append(moe_bound_err(moe[i]))
            continue
        y, _ = M._apply_block(bd, pp, x[:, at:at + 1], cfg, here[None], c,
                              here)
        errs.append(rel_err(y[:, 0], want[:, at]))
    return errs, moe


def decode_parting(params, cfg, seq, at: int, cache_len: int, fe=None):
    """Where a decode step at position `at` (after a prefill of the
    tokens before it) and the train forward over seq[:, :at + 1] part:
    the first decoder block whose output at `at` differs beyond
    SERVE_BOUND."""
    from repro_torch.models import model as M

    _, cache = M.forward(params, cfg, seq[:, :at], fe, mode="prefill",
                         cache_len=cache_len)
    with BlockRecord() as dec:
        M.decode_step(params, cfg, seq[:, at:at + 1], cache)
    with BlockRecord() as full:
        M.forward(params, cfg, seq[:, :at + 1], fe)
    return first_parting(dec.outs, full.outs[encoder_blocks(cfg):],
                         lambda x: x[:, 0], lambda x: x[:, at], SERVE_BOUND)


def attention_blocks(cfg, cache):
    """(mixer, block cache) of every self-attention or MLA block with a
    cache, in order."""
    return [(bd.mixer, c) for bd, c in model_blocks(cfg, cache["segments"])
            if bd.mixer in ("attn", "swa", "dec", "mla")]


def end_to_end(last, cache_leaves, rec, want_last, want_leaves, want_rec):
    """A prefill against another (the plain one): last-position logits,
    the largest cache tensor error and its index, the rows whose first
    greedy token agrees, the first block (an encoder's counted first)
    parting beyond SERVE_BOUND at the last position."""
    errs = [rel_err(a, b) for a, b in zip(cache_leaves, want_leaves)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    last_pos = lambda x: x[:, -1]
    return {"last_logits": rel_err(last, want_last),
            "cache": errs[worst], "cache_tensor": worst,
            "first_tokens_equal": int((last.argmax(-1)
                                       == want_last.argmax(-1)).sum()),
            "parting": first_parting(rec.outs, want_rec.outs, last_pos,
                                     last_pos, SERVE_BOUND)}


def plain_checks(params, cfg, plain_cfg, tokens, cache_len: int, fe, last,
                 prefill_leaves, batch: int, arch: str):
    """`serve_cell`'s checks of a kernels-on prefill (its last-position
    logits `last` and cache tensors `prefill_leaves`) against the plain
    versions: the lockstep of every block (asserted), end to end (the
    first greedy tokens asserted) and SDPA in the kernel's place.
    Returns (lockstep errors, MoE records, end to end, SDPA's end to
    end, whether a re-run's logits equal the main path's)."""
    import torch

    with torch.no_grad():
        p_rec, p_last, p_cache = recorded_prefill(params, plain_cfg, tokens,
                                                  cache_len, fe)
        lock_p, moe_p = lockstep_prefill(cfg, p_rec)
        p_leaves = _leaves(p_cache["segments"])
        del p_cache
        k_rec, k_last, k_cache = recorded_prefill(params, cfg, tokens,
                                                  cache_len, fe)
        rerun_equal = bool(torch.equal(k_last, last))
        del k_cache
        e2e = end_to_end(last, prefill_leaves, k_rec, p_last, p_leaves,
                         p_rec)
        del k_rec
        s_rec, s_last, s_cache = recorded_prefill(params, cfg, tokens,
                                                  cache_len, fe,
                                                  sdpa_attention)
        floor = end_to_end(s_last, _leaves(s_cache["segments"]), s_rec,
                           p_last, p_leaves, p_rec)
        del s_rec, s_cache, p_rec, p_leaves
    assert e2e["first_tokens_equal"] == batch, (
        f"{arch}: the first greedy token of the kernels-on prefill differs "
        f"from the plain one's in {batch - e2e['first_tokens_equal']} rows; "
        f"first block parting (index, error): {e2e['parting']}")
    assert max(lock_p) <= SERVE_BOUND, (
        f"{arch}: a block with kernels differs from its plain version on "
        f"the same input by {max(lock_p):.3g} (bound {SERVE_BOUND}) at "
        f"block {lock_p.index(max(lock_p))}; MoE blocks: {moe_p}")
    for i, r in moe_p.items():
        assert r["topk_set_differs"] <= MOE_FLIP_RATIO * r["sdpa"][
            "topk_set_differs"], (
            f"{arch}: MoE block {i}'s tokens pick another top-k set with the "
            f"kernels than with their plain versions in "
            f"{r['topk_set_differs']:.4%} of them, more than {MOE_FLIP_RATIO}"
            f" x the {r['sdpa']['topk_set_differs']:.4%} with SDPA in the "
            f"kernel's place: {r}")

    return lock_p, moe_p, e2e, floor, rerun_equal


def decode_attention_ms(dev, cfg, params, attn, batch: int, cache_len: int,
                        gen):
    """(mixer, slots, device ms) of the first attention block of `attn`
    (`attention_blocks`): one decode step's attention over its full
    cache (MLA's absorption form over the compressed cache), on a random
    query from `gen`."""
    import torch
    from repro_torch.kernels.flash_attention import (cache_attention,
                                                     decode_attention)
    from repro_torch.models.layers import mla_cache_attention

    mixer, blk = attn[0]
    ln = cache_len
    if mixer == "mla":  # the absorption form over the compressed cache
        m = cfg.mla
        q = torch.randn((batch, cfg.num_heads, 1,
                         m.qk_nope_dim + m.qk_rope_dim), generator=gen,
                        device=dev).to(cfg.torch_dtype)
        wkv_b = [p["mixer"]["wkv_b"] for bd, p in model_blocks(
            cfg, params["segments"]) if bd.mixer == "mla"][0].reshape(
            m.kv_lora_rank, cfg.num_heads, m.qk_nope_dim + m.v_head_dim)
        valid = torch.ones(ln, dtype=torch.bool, device=dev)
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        attend = lambda: mla_cache_attention(
            q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:], blk["ckv"],
            blk["krope"], wkv_b, valid, scale)
    else:
        kc, vc = blk["k"], blk["v"]
        ln = kc.shape[2]
        q = torch.randn((batch, cfg.num_heads, 1, cfg.hd), generator=gen,
                        device=dev).to(cfg.torch_dtype)
        scale = cfg.attn_scale or cfg.hd ** -0.5
        if mixer == "swa" and ln == cfg.window:  # the rolling buffer
            valid = torch.ones((batch, ln), dtype=torch.bool, device=dev)
            attend = lambda: cache_attention(q, kc, vc, valid, scale)
        else:
            length = torch.full((batch,), cache_len, dtype=torch.int32,
                                device=dev)
            window = cfg.window if mixer == "swa" else None
            attend = lambda: decode_attention(q, kc, vc, length, window,
                                              scale)
    return mixer, ln, device_ms(attend, dev, 10)


def decode_state_ms(dev, cfg, params, cache, batch: int, gen) -> dict:
    """{mixer: (device ms, layers)} of one decode step of the first
    'mlstm' and the first 'slstm' block's mixer on its cached state (the
    recurrent forms), on a random input from `gen`; {} without them."""
    import torch
    from repro_torch.models import layers as L

    out = {}
    for (bd, p), (_, c) in zip(model_blocks(cfg, params["segments"]),
                               model_blocks(cfg, cache["segments"])):
        if bd.mixer not in ("mlstm", "slstm") or bd.mixer in out:
            continue
        x1 = torch.randn((batch, 1, cfg.d_model), generator=gen,
                         device=dev).to(cfg.torch_dtype)
        fn = getattr(L, bd.mixer + "_block")
        n = sum(b.mixer == bd.mixer for b, _ in model_blocks(
            cfg, params["segments"]))
        out[bd.mixer] = (device_ms(lambda: fn(p["mixer"], x1, cfg, c), dev,
                                   10), n)
    return out


def serve_cell(dev, arch: str, depth, batch: int, seq: int, steps: int,
               frontend: int = 0, smoke: bool = False):
    """One architecture through the serving entry points: `init_params`
    (seed 19; every cross-attention gate set to SERVE_GATE),
    `make_prefill_step` over a seeded numpy prompt (batch x seq) and,
    with `frontend`, seeded numpy frontend-stub embeddings (batch x
    frontend x frontend_dim; with `smoke`, the smoke config's count) into
    a cache of seq + steps positions, then `steps` greedy
    `make_decode_step` calls; timed, the last decode step profiled.

    Checks, each at SERVE_BOUND (max |a - b| / max |b|):
    * lockstep against the plain versions: every block with the kernels,
      an encoder's too, fed the input (and a decoder block the memory)
      it had in the prefill with every kernel's plain version, against
      that block's output and each of its cache tensors there
      (asserted);
    * lockstep decode: at the first and the last decode step, each
      block's decode (from the cache its own prefill of the earlier
      positions built) against the train forward over the prompt and
      the generated tokens at that position (asserted);
    * end to end: the kernels-on prefill against the plain one (last
      logits, every cache tensor, the first block where they part; the
      first greedy token equal in every row, asserted), and each decode
      step's logits against that train forward's at the same position
      (the share of equal argmaxes; where the bound is not met, the
      first block where a decode step and the forward part). Reported
      beside the same prefill with PyTorch's
      `scaled_dot_product_attention` in the kernel's place: over tens
      of bf16 layers a rounding difference grows to the bound's size
      whichever attention rounds it, so the lockstep checks hold each
      block to the bound and these say how far the whole model drifts.
    Returns (figures, the kernels' launches over the prefill and the
    decode steps)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import decode_attention
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M

    cfg = (get_smoke_config if smoke else get_config)(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    cache_len = seq + steps
    peak_reset(dev)
    params = M.init_params(cfg, 19, dev)
    gated = [blk for bd, blk in model_blocks(cfg, params["segments"])
             if bd.mixer == "xattn"]
    for blk in gated:
        blk["mixer"]["gate_attn"].fill_(SERVE_GATE)
    n_params = sum(p.numel() for p in _leaves(params))
    # what a decode step reads: not the encoder, not the frontend's
    # projection (the cross-attention keys and values are cached)
    n_decoder = n_params - sum(p.numel() for k in (
        "enc_segments", "enc_final_norm", "frontend_proj") if k in params
        for p in _leaves(params[k]))
    rng = np.random.default_rng(19)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(dev)
    fe = None
    if frontend:
        m = cfg.n_frontend_tokens if smoke else frontend
        assert m == cfg.n_frontend_tokens, (arch, m, cfg.n_frontend_tokens)
        fe = torch.from_numpy(rng.standard_normal(
            (batch, m, cfg.frontend_dim)).astype(np.float32)).to(dev)
    prefill = make_prefill_step(cfg, cache_len)
    decode = make_decode_step(cfg)
    # a short prefill and decode step first (library handles, first
    # launches), neither timed nor counted
    warm = min(seq, 128)
    decode(params, tokens[:, :1], prefill(params, tokens[:, :warm], fe)[1])
    sync(dev)

    # the main path: prefill and `steps` greedy decode steps
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, fe)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    last = logits[:, -1].clone()
    del logits
    assert bool(torch.isfinite(last).all()), f"{arch}: non-finite logits"
    prefill_leaves = [t.clone() for t in _leaves(cache["segments"])]
    tok = last.argmax(-1, keepdim=True).to(torch.int32)
    fed, outs, step_s = [], [], []

    def one_step():
        nonlocal tok
        lg, _ = decode(params, tok, cache)
        fed.append(tok)
        outs.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)

    for _ in range(steps - 2):
        t0 = time.perf_counter()
        one_step()
        sync(dev)
        step_s.append(time.perf_counter() - t0)
    # the last two steps under the profiler, the second one traced
    wall, ev = device_events(dev, one_step, warmup=one_step)
    counts = launch_counts()
    peak_main = peak_gb(dev)
    assert len(outs) == steps and int(cache["pos"]) == cache_len
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    step_dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    step_launches = sum(e.count for e in ev)
    top = [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in
           sorted(ev, key=lambda e: -e.self_device_time_total)[:8]]
    pre_prof = None
    if fe is not None or cfg.moe is not None:  # a frontend or MoE
        # cell's prefill, profiled
        run = lambda: prefill(params, tokens, fe)
        p_wall, p_ev = device_events(dev, run, warmup=run)
        dev_ms = lambda evs: sum(e.self_device_time_total for e in evs) / 1e3
        pre_prof = {"wall_ms": p_wall * 1e3, "device_ms": dev_ms(p_ev),
                    "launches": sum(e.count for e in p_ev),
                    "flash_ms": dev_ms(e for e in p_ev
                                       if "flash_fwd" in e.key),
                    "top": [[e.key[:90], e.self_device_time_total / 1e3,
                             e.count] for e in sorted(
                                 p_ev, key=lambda e: -e.self_device_time_total
                             )[:8]]}

    # the prefill against the plain versions: lockstep, then end to end.
    # On a path that launched no kernel on the card (xLSTM: no attention,
    # no RG-LRU) the kernels-on model is the plain one, and the checks
    # would compare a run with itself: skipped, and said so (a CPU
    # rehearsal, which launches none anywhere, runs them)
    kernel_free = dev.type == "cuda" and not any(counts.values())
    if kernel_free:
        log(f"  {arch}: the main path launched no kernel (its launches: "
            f"{counts}); the checks against the plain versions would "
            f"compare a run with itself and are skipped")
        lock_p, moe_p, e2e, floor, rerun_equal = [], {}, None, None, None
    else:
        lock_p, moe_p, e2e, floor, rerun_equal = plain_checks(
            params, cfg, plain_cfg, tokens, cache_len, fe, last,
            prefill_leaves, batch, arch)
    del prefill_leaves

    # decode against the train forward over the prompt and the tokens fed
    seq_all = torch.cat([tokens] + fed, 1)
    with torch.no_grad():
        with BlockRecord() as t_rec:
            full = M.forward(params, cfg, seq_all, fe)
        tf_errs = [rel_err(o, full[:, seq + i]) for i, o in enumerate(outs)]
        agree = float(torch.stack([
            o.argmax(-1) == full[:, seq + i].argmax(-1)
            for i, o in enumerate(outs)]).float().mean())
        del full
        lock_d, moe_d = {}, {}
        for i in (0, steps - 1):
            lock_d[i], moe_d[i] = lockstep_decode(cfg, t_rec, seq + i,
                                                  cache_len)
        del t_rec
        worst = max(range(steps), key=tf_errs.__getitem__)
        # where decode and the forward part, where the bound is missed
        # (not on a kernel-free cell: a prefill and a forward more of the
        # sLSTM's eager loop, ~5 s, for a figure its lockstep already
        # bounds)
        tf_part = (decode_parting(params, cfg, seq_all, seq + worst,
                                  cache_len, fe)
                   if tf_errs[worst] > SERVE_BOUND and not kernel_free
                   else None)
    lock_d_max = max(max(v) for v in lock_d.values())
    assert lock_d_max <= SERVE_BOUND, (
        f"{arch}: a block's decode differs from the train forward on the "
        f"same inputs by {lock_d_max:.3g} (bound {SERVE_BOUND}): {lock_d}")
    flips_d = max([r["flipped_tokens"] for d in moe_d.values()
                   for r in d.values()] or [0])
    assert flips_d <= MOE_DECODE_FLIPS, (
        f"{arch}: at a decode step {flips_d} tokens of {batch} pick another "
        f"top-k set than the train forward's routing of them (at most "
        f"{MOE_DECODE_FLIPS}): {moe_d}")

    # one layer's decode attention over its full cache (an xLSTM
    # layer's state update instead), and the f32 head
    gen = torch.Generator(device=dev).manual_seed(23)
    attn = attention_blocks(cfg, cache)
    mixer, ln, att_ms = (decode_attention_ms(dev, cfg, params, attn, batch,
                                             cache_len, gen)
                         if attn else (None, None, None))
    state_ms = decode_state_ms(dev, cfg, params, cache, batch, gen)
    # a cross-attention block's decode: the cached keys normed again, then
    # `decode_attention` over the memory (plain, as the reference's)
    cross = [(bd, p, c) for (bd, p), (_, c) in zip(
        model_blocks(cfg, params["segments"]),
        model_blocks(cfg, cache["segments"])) if bd.mixer in ("xattn", "dec")]
    xatt_ms = None
    if cross:
        from repro_torch.models.layers import rms_norm

        xbd, xp, xblk = cross[0]
        xw = (xp["mixer"] if xbd.mixer == "xattn" else xp["cross"])
        xw = xw["knorm"]["w"]
        q = torch.randn((batch, cfg.num_heads, 1, cfg.hd), generator=gen,
                        device=dev).to(cfg.torch_dtype)
        xatt_ms = device_ms(lambda: decode_attention(
            q, rms_norm(xblk["xk"], xw), xblk["xv"]), dev, 10)
    x1 = torch.randn((batch, 1, cfg.d_model), generator=gen,
                     device=dev).to(cfg.torch_dtype)
    head_ms = device_ms(lambda: M._logits(params, cfg, x1), dev, 5)

    param_bytes = n_decoder * params["embed"].element_size()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(cache["segments"]))
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    share = lambda ms: ms / step_dev_ms if step_dev_ms else None
    fig = {"layers": cfg.num_layers, "enc_layers": cfg.enc_layers,
           "params": n_params, "decoder_params": n_decoder, "batch": batch,
           "prompt": seq, "frontend_tokens": 0 if fe is None else
           fe.shape[1], "gated_blocks": len(gated),
           "gate_attn": SERVE_GATE if gated else None,
           "decode_steps": steps, "cache_len": cache_len,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": batch * seq / prefill_s,
           "decode_step_ms": [x * 1e3 for x in step_s],
           "decode_median_ms": steady * 1e3,
           "decode_tokens_per_s": batch / steady,
           "prefill_profile": pre_prof,
           "decode_step_profile": {"wall_ms": wall * 1e3,
                                   "device_ms": step_dev_ms,
                                   "launches": step_launches, "top": top},
           "decode_step_bound_ms": (param_bytes + cache_bytes)
           / HBM_BYTES_PER_S * 1e3,
           "decode_attention_ms": att_ms, "attention_layers": len(attn),
           "decode_attention_share":
           None if att_ms is None else share(att_ms * len(attn)),
           "decode_state_ms": {k: ms for k, (ms, _) in state_ms.items()},
           "decode_state_share": share(sum(ms * n for ms, n in
                                           state_ms.values()))
           if state_ms else None,
           "kernel_free": kernel_free,
           "decode_cross_attention_ms": xatt_ms,
           "cross_attention_layers": len(cross),
           "decode_cross_attention_share":
           None if xatt_ms is None else share(xatt_ms * len(cross)),
           "head_ms": head_ms, "head_share": share(head_ms),
           "kv_cache_gb": cache_bytes / 1e9, "peak_gb_main": peak_main,
           "lockstep_prefill_max": max(lock_p) if lock_p else None,
           "lockstep_decode_max": {str(i): max(v) for i, v in lock_d.items()},
           "moe_lockstep": {"prefill": moe_p, "decode": moe_d} if moe_p
           else None,
           "end_to_end_vs_plain": e2e, "sdpa_floor_vs_plain": floor,
           "rerun_last_logits_equal": rerun_equal,
           "teacher_forced": {"max_rel_err": max(tf_errs),
                              "worst_step": worst,
                              "bound_met": tf_errs[worst] <= SERVE_BOUND,
                              "parting": tf_part,
                              "argmax_agreement": agree},
           "peak_gb": peak_gb(dev)}
    met = lambda e: "met" if e <= SERVE_BOUND else "NOT met"
    if fe is not None:
        log(f"  {arch}: {cfg.enc_layers} encoder layers over {fe.shape[1]} "
            f"frontend embeddings a row (seeded normal, batch {batch}); "
            + (f"{len(gated)} gated cross-attention blocks, gate_attn set "
               f"to {SERVE_GATE} (init_params makes it 0)" if gated else
               "no gated cross-attention block ('dec' is ungated)")
            + f"; the decode step's bound reads {n_decoder / 1e9:.3f} B "
            f"decoder parameters")
    log(f"  {arch}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B params, "
        f"batch {batch} x {seq}, cache_len {cache_len} (KV and state "
        f"{cache_bytes / 1e9:.2f} GB): prefill {prefill_s * 1e3:.1f} ms = "
        f"{batch * seq / prefill_s:.0f} tokens/s; decode median "
        f"{steady * 1e3:.2f} ms a step = {batch / steady:.1f} tokens/s at "
        f"batch {batch} (bound {fig['decode_step_bound_ms']:.2f} ms: "
        f"weights and cache read once); peak {peak_main:.1f} GB (the "
        f"checks' {fig['peak_gb']:.1f})")
    log(f"    lockstep, each block with kernels vs plain on the same input: "
        + (f"max {max(lock_p):.2e}" if lock_p else "skipped (no kernel)")
        + f"; each block's decode vs the train forward at steps 0 and "
        f"{steps - 1}: max {lock_d_max:.2e} (bound {SERVE_BOUND}, "
        f"asserted)")
    fmt = lambda e: "none" if e is None else f"{e:.2e}"
    for i, r in moe_p.items():
        dec = [moe_d[st][i - encoder_blocks(cfg)] for st in sorted(moe_d)]
        log(f"    MoE block {i}, kernels vs plain on the plain run's input: "
            f"mixer {r['mixer']:.2e}, FFN {fmt(r['ffn_agreeing'])} on the "
            f"{r['agreeing_tokens']} of {r['tokens']} tokens whose routing "
            f"and kept slots agree (bound {SERVE_BOUND}), top-k set differs "
            f"for {r['topk_set_differs']:.4%} (SDPA in the kernel's place "
            f"{r['sdpa']['topk_set_differs']:.4%}; bound: {MOE_FLIP_RATIO} x "
            f"SDPA's); "
            f"dropped (token, slot) pairs at prefill {r['dropped']:.4%}; "
            f"decode vs the train forward (its FFN on the same tokens) at "
            f"steps 0 and {steps - 1}: "
            + "; ".join(f"mixer {d['mixer']:.2e}, FFN "
                        f"{fmt(d['ffn_agreeing'])} on "
                        f"{d['agreeing_tokens']} of {d['tokens']} tokens, "
                        f"top-k set differs for {d['flipped_tokens']} (at "
                        f"most {MOE_DECODE_FLIPS}), dropped "
                        f"{d['dropped']:.2%} (the forward's "
                        f"{d['dropped_other']:.2%})" for d in dec))
    if e2e is not None:
        log(f"    end to end vs plain (bound {SERVE_BOUND} reported): last "
            f"logits {e2e['last_logits']:.2e} ({met(e2e['last_logits'])}; "
            f"SDPA in the kernel's place {floor['last_logits']:.2e}), cache "
            f"max {e2e['cache']:.2e} at tensor {e2e['cache_tensor']} "
            f"({met(e2e['cache'])}; SDPA {floor['cache']:.2e}), first greedy "
            f"tokens equal in {e2e['first_tokens_equal']} of {batch} rows "
            f"(SDPA {floor['first_tokens_equal']}), first block parting "
            f"{e2e['parting']} (SDPA {floor['parting']}); the re-run's "
            f"logits equal the main path's: {rerun_equal}")
    log(f"    decode vs the teacher-forced forward: max rel err "
        f"{max(tf_errs):.2e} at step {worst} ({met(max(tf_errs))}; first "
        f"block parting {tf_part}), argmax agreement {agree:.4f}")
    log(f"    one decode step profiled: wall {wall * 1e3:.2f} ms, device "
        f"{step_dev_ms:.2f} ms in {step_launches} launches; "
        + ("" if att_ms is None else
           f"decode attention {att_ms:.4f} ms a layer x {len(attn)} "
           f"({mixer}, {ln} slots) = share "
           f"{fig['decode_attention_share']}; ")
        + "".join(f"{k} state step {ms:.4f} ms a layer x {n}; "
                  for k, (ms, n) in state_ms.items())
        + ("" if not state_ms else
           f"(share {fig['decode_state_share']}); ")
        + f"float32 head {head_ms:.3f} ms (share {fig['head_share']})"
        + ("" if xatt_ms is None else
           f"; cross-attention decode (keys normed again, plain) "
           f"{xatt_ms:.4f} ms a layer x {len(cross)} = share "
           f"{fig['decode_cross_attention_share']}"))
    for name, ms, n in top[:5]:
        log(f"      {ms:9.3f} ms {n:5d}x  {name}")
    if pre_prof is not None:
        log(f"    one prefill profiled: wall {pre_prof['wall_ms']:.2f} ms, "
            f"device {pre_prof['device_ms']:.2f} ms in "
            f"{pre_prof['launches']} launches, flash_attention_fwd "
            f"{pre_prof['flash_ms']:.2f} ms of it")
        for name, ms, n in pre_prof["top"][:5]:
            log(f"      {ms:9.3f} ms {n:5d}x  {name}")
    return fig, counts


def phase_serve_lm(dev, cells=SERVE_CELLS, smoke: bool = False):
    """Every cell of `cells` through `serve_cell`: (figures by
    architecture, the launches summed over the cells' main paths)."""
    import torch

    figs, total = {}, {}
    for arch, depth, batch, seq, steps, frontend in cells:
        figs[arch], counts = serve_cell(dev, arch, depth, batch, seq, steps,
                                        frontend, smoke)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return figs, total


# -- phase 20: xLSTM-350M training, the mLSTM forms, rematerialisation ------

MLSTM_CHUNKED_BOUND = 1e-4    # chunkwise vs quadratic, max |a - b| / max |b|
MLSTM_RECURRENT_BOUND = 1e-3  # chunkwise vs the recurrent form, token by token


def mlstm_forms(dev, batch: int = 4, seq: int = 2048, smoke: bool = False):
    """One mLSTM block of xLSTM-350M at full width (d 1,024, 4 heads of
    512; with `smoke` the smoke config's) in float32 over a seeded batch
    x seq input: the chunkwise form (chunk 256) against the quadratic
    form over every position (outputs and final state), and against the
    recurrent form stepped token by token from the zero state (outputs
    and final (C, n, m)); each form timed once on the host clock after a
    synchronise (the quadratic form twice, the first call warming up)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = dataclasses.replace((get_smoke_config if smoke else get_config)(
        "xlstm-350m"), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(20)
    p = L.init_mlstm(gen, cfg, torch.float32)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        _, q, k, v, li, lf = L.mlstm_inputs(p, x, cfg)
        quad = lambda: L.mlstm_parallel(q, k, v, li, lf, return_state=True)
        timed(quad)
        (par, par_st), par_ms = timed(quad)
        (chk, chk_st), chk_ms = timed(
            lambda: L.mlstm_chunked(q, k, v, li, lf, 256))

        def recurrent():
            st = M._block_cache(cfg.pattern[0], cfg, batch, 1, torch.float32,
                                dev)
            outs = []
            for t in range(seq):
                o, st = L.mlstm_step(st, q[:, :, t:t + 1], k[:, :, t:t + 1],
                                     v[:, :, t:t + 1], li[..., t:t + 1],
                                     lf[..., t:t + 1])
                outs.append(o)
            return torch.cat(outs, 2), st

        (rec, rec_st), rec_ms = timed(recurrent)
        err = {"chunked_vs_quadratic": rel_err(chk, par),
               "chunked_state_vs_quadratic": max(
                   rel_err(chk_st[n], par_st[n]) for n in ("C", "n", "m")),
               "chunked_vs_recurrent": rel_err(chk, rec),
               "chunked_state_vs_recurrent": {
                   n: rel_err(chk_st[n], rec_st[n]) for n in ("C", "n", "m")}}
    assert err["chunked_vs_quadratic"] <= MLSTM_CHUNKED_BOUND, err
    assert max([err["chunked_vs_recurrent"]]
               + list(err["chunked_state_vs_recurrent"].values())
               ) <= MLSTM_RECURRENT_BOUND, err
    fig = {"batch": batch, "seq": seq, "d": cfg.d_model,
           "heads": cfg.num_heads, "errors": err,
           "quadratic_ms": par_ms, "chunked_ms": chk_ms,
           "recurrent_ms": rec_ms}
    log(f"  mLSTM forms, one block at d {cfg.d_model}, {cfg.num_heads} heads "
        f"of {2 * cfg.d_model // cfg.num_heads}, float32, {batch} x {seq}: "
        f"chunkwise vs quadratic {err['chunked_vs_quadratic']:.2e} (bound "
        f"{MLSTM_CHUNKED_BOUND}; states "
        f"{err['chunked_state_vs_quadratic']:.2e}), vs the recurrent form "
        f"token by token {err['chunked_vs_recurrent']:.2e}, final (C, n, m) "
        + ", ".join(f"{v:.2e}" for v in
                    err["chunked_state_vs_recurrent"].values())
        + f" (bound {MLSTM_RECURRENT_BOUND}); quadratic {par_ms:.1f} ms, "
        f"chunkwise {chk_ms:.1f} ms, recurrent {rec_ms:.1f} ms")
    return fig


def mixer_fwd_bwd_ms(dev, cfg, mixer: str, batch: int, seq: int) -> float:
    """Host milliseconds of one `mixer` block's mixer, forward and
    backward, on seeded (batch, seq, d) input in the model dtype, from a
    synchronise to a synchronise (one call: the training run before it
    warmed up the same operations)."""
    import torch
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(21)
    p = getattr(L, "init_" + mixer)(gen, cfg, cfg.torch_dtype)
    for t in p.values():
        if isinstance(t, torch.Tensor):
            t.requires_grad_()
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev
                    ).to(cfg.torch_dtype).requires_grad_()
    fn = getattr(L, mixer + "_block")
    sync(dev)
    t0 = time.perf_counter()
    y, _ = fn(p, x, cfg)
    y.float().sum().backward()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3


def phase_train_xlstm(dev, steps: int = 2, batch: int = 4, seq: int = 2048,
                      remat_steps: int = 1, smoke: bool = False):
    """xLSTM-350M at full width and depth (24 blocks, 0.50 B parameters)
    through `run_plain`: `steps` steps, finite, the first loss within 0.5
    of ln V + 1/2 (a random tied head's logits have variance 1: RMS-normed
    states against an N(0, 1/d) embedding); then `remat_steps` steps with
    ``remat="block"``, whose losses and grad norms must equal the first
    ones' (the schedule's scale is 1 at step 0 for any length) with a
    lower peak; then one mLSTM and one sLSTM block forward and backward
    at the step's shapes, for the step's breakdown. Returns (figures, the
    launches of both runs)."""
    import dataclasses
    import math

    import numpy as np
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.launch.train import run_plain

    cfg = (get_smoke_config if smoke else get_config)("xlstm-350m")
    kw = dict(arch="xlstm-350m", batch=batch, seq_len=seq, device=str(dev))
    reset_launches()
    peak_reset(dev)
    res = run_plain(train_args(steps=steps, **kw), cfg=cfg)
    sync(dev)
    peak = peak_gb(dev)
    n_params = sum(p.numel() for p in _leaves(res.params))
    res.params = None
    want0 = math.log(cfg.vocab_size) + 0.5
    assert all(np.isfinite(res.losses + res.grad_norms)), (
        res.losses, res.grad_norms)
    assert abs(res.losses[0] - want0) <= 0.5, (
        f"xLSTM's first loss {res.losses[0]} is not within 0.5 of "
        f"ln V + 1/2 = {want0}")
    peak_reset(dev)
    rem = run_plain(train_args(steps=remat_steps, **kw),
                    cfg=dataclasses.replace(cfg, remat="block"))
    sync(dev)
    peak_remat = peak_gb(dev)
    counts = launch_counts()
    rem.params = None
    pairs = list(zip(rem.losses + rem.grad_norms,
                     res.losses[:remat_steps] + res.grad_norms[:remat_steps]))
    d_remat = max(abs(a - b) / abs(b) for a, b in pairs)
    bitwise = all(a == b for a, b in pairs)
    assert d_remat <= 1e-6, (
        f"remat='block' changed the run: {rem.losses}, {rem.grad_norms} "
        f"against {res.losses}, {res.grad_norms}")
    if dev.type == "cuda":
        assert peak_remat < peak, (peak_remat, peak)
    later = sorted(res.step_seconds[1:])
    steady = later[len(later) // 2]
    step_ms = steady * 1e3
    mixers = {m: mixer_fwd_bwd_ms(dev, cfg, m, batch, seq)
              for m in ("mlstm", "slstm")}
    n_of = {m: sum(bd.mixer == m for pat, n in cfg.segments() for bd in pat
                   for _ in range(n)) for m in mixers}
    fig = {"layers": cfg.num_layers, "params": n_params, "batch": batch,
           "seq": seq, "losses": res.losses, "grad_norms": res.grad_norms,
           "first_loss_expected": want0,
           "step_ms": [x * 1e3 for x in res.step_seconds],
           "median_step_ms": step_ms, "tokens_per_s": batch * seq / steady,
           "peak_gb": peak, "remat": {
               "losses": rem.losses, "grad_norms": rem.grad_norms,
               "max_rel_diff": d_remat, "bitwise_equal": bitwise,
               "step_ms": [x * 1e3 for x in rem.step_seconds],
               "peak_gb": peak_remat},
           "mixer_fwd_bwd_ms": mixers, "mixer_layers": n_of,
           "mixer_share": {m: mixers[m] * n_of[m] / step_ms for m in mixers}}
    log(f"  xLSTM-350M ({cfg.num_layers} blocks, {n_params / 1e9:.3f} B "
        f"params), batch {batch} x {seq}, run_plain {steps} steps: losses "
        f"{[round(x, 4) for x in res.losses]} (first within 0.5 of ln V + "
        f"1/2 = {want0:.4f}), grad norms "
        f"{[round(x, 3) for x in res.grad_norms]}; median step "
        f"{step_ms:.1f} ms = {batch * seq / steady:.0f} tokens/s; peak "
        f"{peak:.2f} GB")
    log(f"    remat='block', {remat_steps} steps: losses and grad norms "
        f"{'bitwise equal' if bitwise else f'within {d_remat:.1e}'}; peak "
        f"{peak_remat:.2f} GB against {peak:.2f}; steps "
        f"{[round(x * 1e3, 1) for x in rem.step_seconds]} ms")
    log(f"    one block's mixer forward + backward at {batch} x {seq}: "
        + "; ".join(f"{m} {mixers[m]:.1f} ms x {n_of[m]} = "
                    f"{fig['mixer_share'][m]:.0%} of the step"
                    for m in mixers))
    return fig, counts


def phase_remat_smollm(dev, batch: int = 4, seq: int = 2048,
                       smoke: bool = False):
    """SmolLM-135M (30 periods of one attention block) through one
    `run_plain` step under each ``remat``: losses and grad norms equal,
    `flash_attention_fwd` launched once a layer without remat, twice
    under "block" (the recompute) and once under "block_save_flash" (its
    outputs kept), the peak of each. Returns (figures, the launches of
    the three runs)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.wheel import launch_counts, reset_launches
    from repro_torch.launch.train import run_plain
    from repro_torch.models.model import REMATS

    cfg = (get_smoke_config if smoke else get_config)("smollm-135m")
    kw = dict(arch="smollm-135m", batch=batch, seq_len=seq, device=str(dev),
              steps=1)
    runs, total = {}, {}
    for remat in REMATS:
        reset_launches()
        peak_reset(dev)
        res = run_plain(train_args(**kw),
                        cfg=dataclasses.replace(cfg, remat=remat))
        sync(dev)
        res.params = None
        counts = launch_counts()
        runs[remat] = {"loss": res.losses[0], "grad_norm": res.grad_norms[0],
                       "step_ms": res.step_seconds[0] * 1e3,
                       "flash_launches": counts["flash_attention_fwd"],
                       "peak_gb": peak_gb(dev)}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    base = runs["none"]
    for remat, r in runs.items():
        for key in ("loss", "grad_norm"):
            d = abs(r[key] - base[key]) / abs(base[key])
            assert d <= 1e-6, f"remat={remat!r} changed the {key}: {runs}"
    if dev.type == "cuda":
        layers = cfg.num_layers
        got = [runs[r]["flash_launches"] for r in REMATS]
        assert got == [layers, 2 * layers, layers], (
            f"flash forward launches under remat {REMATS}: {got}, want "
            f"{[layers, 2 * layers, layers]}")
    log(f"  SmolLM-135M, batch {batch} x {seq}, one step under each remat: "
        + "; ".join(f"{r}: loss {v['loss']:.6f}, grad norm "
                    f"{v['grad_norm']:.6f}, flash forward launches "
                    f"{v['flash_launches']}, peak {v['peak_gb']:.2f} GB, step "
                    f"{v['step_ms']:.1f} ms" for r, v in runs.items()))
    return runs, total


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
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.wheel import launch_counts, reset_launches

    dev = torch.device("cuda", 0)
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
            if "Used" in line or "wgmma" in line:
                log(f"  {src}: {line.strip()}")
    sass = flash_sass_report(out)
    log("  flash_attention_fwd HGMMA instructions per instantiation "
        "(cuobjdump -sass; bf16 on the tensor cores, f32 on the CUDA "
        "cores): " + json.dumps(sass, sort_keys=True))
    l2_ptxas = ptxas_of("threshold_step", "l2_threshold_general_kernel")
    log(f"  the general L2 kernel (ptxas; its shared memory is dynamic, "
        f"sized per shape in phase 2): {json.dumps(l2_ptxas)}")

    log("phase 2: kernels vs plain versions at the n = 1e6 shapes")
    # the first profiler sessions of a process can drop device events:
    # warm the profiler up before any measurement
    x = torch.ones(1 << 20, device=dev)
    device_ms(lambda: x.mul_(1.0), dev, 20)
    dargs, eng_a = capture_descent(N_BIG, dev, cycles=12)
    sizes = {"staged": eng_a.lanes * 4 * eng_a.window_l,
             "window": eng_a.lanes * eng_a.window_l, "pad": eng_a.pad,
             "links": eng_a.pad * 3, "descent": (dargs, eng_a)}
    log(f"  shapes: pad {eng_a.pad}, {eng_a.lanes} lanes, lane_budget "
        f"{eng_a.lane_budget}, window_l {eng_a.window_l}, WW {sizes['window']}"
        f", narrow NT {dargs[0].shape[0]}, staged rows {sizes['staged']}")
    rows = phase_kernels(dev, sizes, iters=20)
    rows["threshold_step_l2_general"]["ptxas"] = l2_ptxas
    rows["threshold_step_l2_general"]["cuda_tests"] = phase_l2_cuda_tests()
    p2_rows = {"descent_tail": int(dargs[0].shape[0]),
               "threshold_step": sizes["window"], "stage_rows": sizes["staged"]}
    del eng_a, sizes, dargs
    torch.cuda.empty_cache()

    log("phase 3: engine parity, kernels vs plain versions, on the card")
    n3 = 4096
    # the churn cells' kernels-on digests: phase 17's sharded engines must
    # reproduce them
    shard_want, paths = {}, {}
    for cell, label in (("majority", "majority"), ("mean", "mean"),
                        ("l2", "l2"), ("majority_no_threshold",
                                       "majority without the threshold "
                                       "kernel")):
        counts, shard_want[cell] = phase_parity_churn(dev, cell, label)
    paths["majority_no_threshold"] = counts
    reset_launches()
    phase_parity_l2_any_dim(dev, n3, 9)
    paths["l2_any_dim"] = launch_counts()

    log("phase 4: majority main path at n = 100,000")
    reset_launches()
    conv = phase_converge(dev, N_MID)
    log("phase 5: n = 1,000,000 majority peers")
    big, big_stats = phase_big(dev, N_BIG, 100)
    paths["majority"] = launch_counts()
    # what phase 17's sharded engine at world 1 must reproduce
    big_ref = {"digest": snapshot(big), "counters": big_counters(big),
               "outputs": hashlib.sha256(big.outputs().tobytes()).hexdigest()}
    big_stats["profile"] = phase_profile(dev, big, 10)
    big_ref["device_ms_per_cycle"] = \
        big_stats["profile"]["device_ms_per_cycle"]
    del big
    torch.cuda.empty_cache()

    log("phase 6: mean and L2 at n = 100,000 (the golden-cell script)")
    reset_launches()
    conv_p = {name: phase_problem_converge(dev, name, N_MID)
              for name in ("mean", "l2")}
    log("phase 7: L2 at n = 1,000,000 with churn")
    big, big_l2 = phase_big_churn(dev, N_BIG, events=16, gap=6)
    paths["mean_l2"] = launch_counts()
    big_l2["profile"] = phase_profile(dev, big, 10)
    free = int(np.setdiff1d(np.arange(1, 1 << 20, dtype=np.uint64),
                            big.ring.addrs)[7])
    big_l2.update(profile_churn_event(dev, big, free))
    assert big.dropped == 0
    big.check_conservation()
    del big
    torch.cuda.empty_cache()

    log("phase 8: the training substrate's kernels vs plain versions at "
        "the trainer's shapes")
    rows.update(phase_train_kernels(dev, iters=20))
    rows["flash_attention_fwd"]["sass"] = sass
    torch.cuda.empty_cache()
    log("phase 9: RecurrentGemma-9B, full width, depth 3, batch 1 x 4096, "
        "run_plain, 4 steps")
    rg, paths["train_rg9b"], (rg_cfg, rg_params, rg_args) = phase_train_rg(dev)
    rg["profile"] = profile_train_step(dev, rg_cfg, rg_params, rg_args)
    del rg_params
    torch.cuda.empty_cache()
    log("phase 10: SmolLM-135M (30 layers), threshold sync, 2 pods, "
        "compress tau 1e-4, max inner 4, batch 8 x 2048, 12 steps")
    sm, paths["train_smollm_threshold"] = phase_train_smollm(dev)
    torch.cuda.empty_cache()

    log("phase 12: the fault plane, kernels-on vs plain engines on the "
        "card: the differential harness's four fault schedules, and the "
        "majority crash schedule without the threshold kernel")
    reset_launches()
    for i, cell in enumerate(FAULT_GRID):
        digests = phase_fault_parity(dev, fault_schedule(*cell), "auto")
        if i == 0:
            shard_want["armed"] = digests  # phase 17 reproduces it
    paths["armed"] = launch_counts()
    reset_launches()
    phase_fault_parity(dev, fault_schedule(*FAULT_GRID[0]),
                       ("enqueue", "descent"))
    paths["armed_no_threshold"] = launch_counts()
    log(f"phase 13: the fault plane at scale: majority at n = {N_BIG:,} "
        f"armed with drops and delays, toward convergence (at most "
        f"{ARMED_BIG_CYCLES} cycles); n = {N_MID:,} with 16 crashes, "
        f"evicted and reconverged")
    reset_launches()
    big, armed = phase_armed_big(dev, N_BIG, ARMED_BIG_CYCLES, p2_rows)
    armed["profile"] = phase_profile(dev, big, 10)
    del big
    torch.cuda.empty_cache()
    spread = lambda lo: [int(i) for i in np.linspace(lo, N_MID - lo, 16)]
    armed["crash_1e5"] = phase_armed_crash(dev, N_MID, 41,
                                           spread(N_MID // 64), exact=True,
                                           bridge=True)
    # the schedule on which the reference's detector (its numpy oracle
    # too) evicts a live neighbour of a crashed peer: every crashed peer
    # must still go and the survivors converge; the live ones are counted
    armed["crash_1e5_seed7"] = phase_armed_crash(dev, N_MID, 7,
                                                 spread(1000), exact=False)
    paths["armed"] = {k: v + paths["armed"][k]
                      for k, v in launch_counts().items()}
    torch.cuda.empty_cache()

    log(f"phase 14: L2 at D = 9 with its default cover (the general L2 "
        f"kernel) at n = {N_BIG:,}")
    reset_launches()
    big, l2_d9 = phase_big_l2_any_dim(dev, N_BIG, 9, 100)
    paths["l2_any_dim"] = {k: v + paths["l2_any_dim"][k]
                           for k, v in launch_counts().items()}
    l2_d9["profile"] = phase_profile(dev, big, 10,
                                     kernel="l2_threshold_general",
                                     count_as="threshold_step_l2_general")
    assert big.dropped == 0
    big.check_conservation()
    del big
    torch.cuda.empty_cache()

    log(f"phase 15: batched trials: kernels-on B-trial engines vs serial "
        f"engines at n = 4096; the sweep grid (B = 24) at n = {N_MID:,}; "
        f"B = 4 at n = {N_BIG:,}")
    phase_batched_parity(dev, 4096)
    torch.cuda.empty_cache()
    # the batched path's one window: the sweep's engine (built, run to
    # convergence, 3 cycles at per-trial t) and B = 4 at 1e6
    reset_launches()
    sweep, sweep_ctx = phase_sweep(dev, N_MID)
    torch.cuda.empty_cache()
    big, sweep["b4_1e6"] = phase_batched_big(dev, N_BIG, 4, 100)
    paths["batched"] = launch_counts()
    sweep["b4_1e6"]["profile"] = phase_profile(dev, big, 10)
    del big
    torch.cuda.empty_cache()
    sweep["serial"] = sweep_reruns(dev, sweep_ctx)
    del sweep_ctx
    sweep["profile"] = sweep_profile(dev, N_MID, 10)
    torch.cuda.empty_cache()

    log(f"phase 16: the serve layer: kernels-on vs plain on the three serve "
        f"schedules at n = 4096; majority at n = {N_MID:,} under 16 bursts")
    reset_launches()
    phase_serve_parity(dev, 4096)
    serve = phase_serve_load(dev, N_MID)
    paths["serve"] = launch_counts()
    torch.cuda.empty_cache()

    log(f"phase 17: the sharded engine: kernels-on ShardedTorchEngine vs "
        f"phases 3 and 12's kernels-on single engines at n = {CHURN_N} and "
        f"on the first fault schedule (worlds 1, 2, 4); "
        f"phase 4 at n = {N_MID:,} on each world; phase 5 at n = {N_BIG:,} "
        f"at world 1")
    shard, paths["sharded"] = phase_sharded(dev, conv, big_ref, shard_want,
                                            serve)
    torch.cuda.empty_cache()

    log("phase 18: the control plane: the elastic drills at 4,096 hosts "
        "(kernels vs plain versions); SmolLM-135M run_plain with a checkpoint "
        "every 2 steps and a failure at step 4 of 6, against an "
        "uninterrupted run")
    drills, paths["control"] = phase_drills(dev)
    resume, paths["train_smollm_resume"] = phase_resume(dev)
    torch.cuda.empty_cache()

    log("phase 19: LM prefill and cached decode on the serving entry "
        "points: Gemma-7B (full config) 4 x 2048 and 64 greedy steps; "
        "RecurrentGemma-9B at depth 3, 1 x 4096 and 32 steps (past its "
        "window); MiniCPM-2B (full config) 4 x 2048 and 16 steps; "
        "Command-R-35B at depth 4, 2 x 2048 and 16 steps; Whisper-large-v3 "
        "(full config) 8 x 1500 frames, a 128-token prompt and 64 steps; "
        "Llama-3.2-Vision-11B (full config) 4 x 2048 with 4100 vision "
        "tokens and 32 steps; DeepSeek-V3 at depth 4 (3 dense + 1 MoE "
        "layer), 4 x 2048 and 32 steps; Arctic at depth 2, 4 x 2048 and "
        "32 steps; xLSTM-350M (full config) 4 x 2048 and 32 steps; then "
        "flash_attention_fwd at the cells' prefill shapes, "
        "causal and non-causal, MLA's with v narrower than q and k")
    serve_lm, paths["serve_lm"] = phase_serve_lm(dev)
    flash_rows(dev, rows, 20, torch.Generator(device=dev).manual_seed(2029),
               SERVE_FLASH, clocks=False)
    torch.cuda.empty_cache()

    log("phase 20: xLSTM-350M training and the mLSTM forms: one mLSTM block "
        "at full width in float32, 4 x 2048, chunkwise vs quadratic vs "
        "recurrent; run_plain at full depth, 4 x 2048, 2 steps, then 1 with "
        "remat='block'; SmolLM-135M, 4 x 2048, one step under each remat")
    xlstm = {"mlstm_forms": mlstm_forms(dev)}
    torch.cuda.empty_cache()
    xlstm["train"], paths["train_xlstm"] = phase_train_xlstm(dev)
    torch.cuda.empty_cache()
    xlstm["remat_smollm"], paths["remat"] = phase_remat_smollm(dev)
    torch.cuda.empty_cache()

    for path, counts in paths.items():
        for name, k in counts.items():
            if name in PATH_KERNELS[path]:
                assert k > 0, f"kernel {name} was not launched on path {path}"
            else:
                assert k == 0, f"kernel {name} launched on path {path}"

    log("phase 11: kernels on their paths (majority wheel kernels: phases "
        "4-5; mean/L2: phases 6-7; majority without the threshold kernel: "
        "phase 3; L2 at D = 9 (the general L2 kernel): phases 3 and 14; "
        "RG-9B trainer: phase 9; SmolLM threshold trainer: phase "
        "10; armed: phases 12-13, without the threshold kernel: phase 12's "
        "last schedule; batched: phase 15's sweep and B = 4 at 1e6 (one "
        "launch of each wheel kernel a batched cycle, as the single "
        "engine's); serve: phase 16; sharded: phase 17's ranks, summed, its "
        "control plane too; control: phase 18's drills with kernels; "
        "train_smollm_resume: phase 18's two run_plain runs; serve_lm: phase "
        "19's prefills and decode steps; train_xlstm: phase 20's xLSTM "
        "runs, no kernel; remat: phase 20's SmolLM steps): "
        + json.dumps(paths))
    table = []
    for name, (src, rep) in SOURCES.items():
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": rep,
                      "launches": paths[MAIN_PATH[name]][name],
                      "launches_by_path": {p: c[name] for p, c in paths.items()
                                           if name in PATH_KERNELS[p]},
                      **rows[name]})
    log(f"summary: {json.dumps({'converge_1e5': conv, 'n_1e6': big_stats, 'problems_1e5': conv_p, 'l2_1e6_churn': big_l2, 'train_rg9b': rg, 'train_smollm_threshold': sm, 'armed': armed, 'l2_d9_1e6': l2_d9, 'batched': sweep, 'serve': {k: v for k, v in serve.items() if k not in ('transition_digests', 'burst_marks', 'settle_cycles', 'settle_ms')}, 'sharded': shard, 'drills': drills, 'resume': resume, 'serve_lm': serve_lm, 'xlstm': xlstm})}")
    log(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
