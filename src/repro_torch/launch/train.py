"""Training entry point of the port: data pipeline -> train step, with plain
data-parallel training (`run_plain`) or the paper-mode threshold-gated
outer sync across pod replicas (`run_threshold`). The same CLI and log
lines as `repro.launch.train`, plus ``--device`` (default cuda).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --device cpu --steps 10 --batch 4 --seq-len 32
    ... --sync threshold --pods 2 --compress-tau 1e-3

Fault tolerance in `run_plain`, as the reference's: ``--ckpt-dir`` saves
the parameters, the AdamW state and the data pipeline's position every
``--ckpt-every`` steps (`ckpt.checkpoint.CheckpointManager`, async) and
resumes from the newest checkpoint there; ``--fail-at k`` injects one
failure at step k, after which the `RestartPolicy` restores the newest
checkpoint and the run goes on. A checkpoint labelled step s holds the
state after step s, so the run resumes at step s + 1 and its losses and
final parameters are those of an uninterrupted run.

    ... --steps 6 --ckpt-dir /tmp/ck --ckpt-every 2 --fail-at 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import threshold_sync as TS
from repro_torch.launch import steps as S
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.fault_tolerance import RestartPolicy


@dataclasses.dataclass
class RunResult:
    """What a run returns: the last step's loss (the reference's return
    value) and the per-step record: `steps[i]` is the step whose loss is
    `losses[i]` (a step replayed after a restore appears again). In
    threshold mode `losses` are the mean over pods and `grad_norms` the
    per-pod norms."""

    loss: float
    losses: List[float]
    grad_norms: List
    step_seconds: List[float]
    params: object
    n_syncs: int = 0
    sync_steps: List[int] = dataclasses.field(default_factory=list)
    sent_bytes: int = 0
    steps: List[int] = dataclasses.field(default_factory=list)
    restored: List[int] = dataclasses.field(default_factory=list)
    ckpt_seconds: List[float] = dataclasses.field(default_factory=list)
    restore_seconds: List[float] = dataclasses.field(default_factory=list)


def build(args, cfg: Optional[ModelConfig] = None):
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = AdamWConfig(lr=args.lr)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=args.seed,
    ))
    return cfg, opt, data


def _device_batch(batch, dev):
    return tuple(torch.from_numpy(b).to(dev) for b in batch)


def run_plain(args, cfg: Optional[ModelConfig] = None, params=None) -> RunResult:
    """Standard data-parallel training with every-step gradient sync, and
    with ``args.ckpt_dir`` checkpoints, resume and restart after a
    failure (module docstring). `cfg` overrides the registry config;
    `params` the seeded init."""
    dev = resolve_device(args.device)
    cfg, opt, data = build(args, cfg)
    if params is None:
        params = init_params(cfg, args.seed, dev)
    opt_state = init_state(params)
    step_fn = S.make_train_step(cfg, opt, args.schedule, args.steps)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    res = RunResult(0.0, [], [], [], params)
    fail_at = args.fail_at

    def restore() -> int:
        """The newest checkpoint's state; returns the step to run next."""
        nonlocal params, opt_state
        ts = time.perf_counter()
        mgr.wait()  # a save still in flight is the newest
        got = mgr.restore_latest({"params": params, "opt": opt_state})
        if got is None:
            return -1
        last, tree, extra = got
        params, opt_state = tree["params"], tree["opt"]
        data.load_state_dict(extra["data"])
        res.restore_seconds.append(time.perf_counter() - ts)
        res.restored.append(last)
        return last + 1

    def checkpoint(step: int) -> None:
        ts = time.perf_counter()
        mgr.save_async(step, {"params": params, "opt": opt_state},
                       {"data": data.state_dict()})
        res.ckpt_seconds.append(time.perf_counter() - ts)

    step = 0
    if mgr is not None:
        step = max(restore(), 0)
        if step:
            print(f"[train] resumed from step {step - 1}")
    policy = RestartPolicy()
    t0 = time.time()
    try:
        while step < args.steps:
            try:
                ts = time.perf_counter()
                batch = data.next_batch()
                if fail_at is not None and step == fail_at:
                    fail_at = None  # the injected failure fires once
                    raise RuntimeError("injected failure (--fail-at)")
                tokens, targets = _device_batch(batch, dev)
                params, opt_state, m = step_fn(params, opt_state, tokens,
                                               targets)
                loss = float(m["loss"])  # the step's one host read
                res.step_seconds.append(time.perf_counter() - ts)
                res.steps.append(step)
                res.losses.append(loss)
                res.grad_norms.append(float(m["grad_norm"]))
                if step % args.log_every == 0:
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"gnorm={res.grad_norms[-1]:.3f} lr={m['lr']:.2e} "
                          f"({time.time()-t0:.1f}s)")
                if mgr is not None and step and step % args.ckpt_every == 0:
                    checkpoint(step)
                step += 1
            except RuntimeError as e:
                delay = policy.next_delay()
                if delay is None or mgr is None:
                    raise
                print(f"[train] failure at step {step}: {e}; restoring "
                      f"(backoff {delay:.1f}s)")
                time.sleep(min(delay, 0.2))
                nxt = restore()
                if nxt < 0:
                    raise
                step = nxt
        if mgr is not None and res.steps:
            checkpoint(step - 1)
    finally:
        if mgr is not None:
            mgr.close()
    res.loss, res.params = (res.losses[-1] if res.losses else 0.0), params
    return res


def run_threshold(args, cfg: Optional[ModelConfig] = None,
                  params=None) -> RunResult:
    """Paper mode: per-pod local steps + violation-voted outer sync.

    The pods are G model replicas on one device, stepped in turn (the
    reference's vmap over its G axis)."""
    dev = resolve_device(args.device)
    cfg, opt, _ = build(args, cfg)
    G = args.pods
    tcfg = TS.ThresholdSyncConfig(
        tau=args.tau, compress_tau=args.compress_tau,
        max_inner_steps=args.max_inner,
    )
    params0 = init_params(cfg, args.seed, dev) if params is None else params
    params_g = TS.replicate_for_pods(params0, G)
    opt_g = [init_state(p) for p in params_g]
    outer = TS.init_outer_state(params0, tcfg)
    del params0
    base_step = S.make_train_step(cfg, opt, args.schedule, args.steps)
    sync = TS.make_sync_step(tcfg, use_kernel=cfg.use_kernels)

    per_pod = args.batch // G
    datas = [
        SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, per_pod,
                               seed=args.seed + 101 * g))
        for g in range(G)
    ]
    res = RunResult(0.0, [], [], [], params_g)
    n_syncs, since, sent = 0, 0, 0
    for step in range(args.steps):
        ts = time.perf_counter()
        losses, norms = [], []
        for g in range(G):
            tokens, targets = _device_batch(datas[g].next_batch(), dev)
            params_g[g], opt_g[g], m = base_step(params_g[g], opt_g[g],
                                                 tokens, targets)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        drift, votes = TS.drift_and_votes(params_g, outer["agreement"], tcfg)
        since += 1
        if TS.should_sync(votes.cpu().numpy(), since, tcfg):
            params_g, outer, sm = sync(params_g, outer)
            n_syncs += 1
            since = 0
            sent += int(sm["sync_sent_bytes"])
            res.sync_steps.append(step)
        loss = float(np.mean([float(x) for x in losses]))
        res.step_seconds.append(time.perf_counter() - ts)
        res.losses.append(loss)
        res.grad_norms.append([float(x) for x in norms])
        if step % args.log_every == 0:
            print(f"[tsync] step={step} loss={loss:.4f} "
                  f"drift={float(drift.mean()):.4f} syncs={n_syncs} "
                  f"sync_rate={n_syncs/(step+1):.2f}")
    print(f"[tsync] total outer syncs: {n_syncs}/{args.steps} steps "
          f"({100*n_syncs/args.steps:.0f}% of every-step DP volume)")
    res.loss, res.params = res.losses[-1], params_g
    res.n_syncs, res.sent_bytes = n_syncs, sent
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=("cosine", "linear", "wsd"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (run_plain): save and resume")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault-tol demo)")
    ap.add_argument("--sync", default="plain", choices=("plain", "threshold"))
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--tau", type=float, default=0.02)
    ap.add_argument("--compress-tau", type=float, default=0.0)
    ap.add_argument("--max-inner", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the CPU)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.sync == "threshold":
        run_threshold(args)
    else:
        run_plain(args)


if __name__ == "__main__":
    main()
