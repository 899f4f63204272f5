"""Rank programs of the sharded engine's CPU tests
(tests/test_torch_sharded.py, tests/test_torch_sharded_faults.py).

`launch.mesh.spawn` runs them in fresh processes, one a rank; they import
torch and the port only (no jax, no `repro`), so a rank starts quickly.
A schedule arrives as plain data (`spec`): the ring's addresses, the
problem by name and arguments, the data, the engine seed, the fault
configuration and the events of a `tests/_diff_harness.make_schedule`
schedule, drawn in the test process.
"""
from __future__ import annotations

import os

import numpy as np

MAX_CYCLES = 40_000  # tests/_diff_harness.py's


def background() -> None:
    """Lower this rank's scheduling priority: a world's ranks are processes
    beyond the test run's workers, and must not starve the tests that
    time themselves (the engine benchmark's smoke test) running beside
    them."""
    os.nice(10)


def build(spec: dict, dev, world: int):
    """The engine of `spec`: `TorchEngine` when `world` is 0, else the
    sharded engine over the default group (with `spec["gather_bytes"]`,
    its host gathers go in slices of that many device bytes)."""
    from repro_torch.core.dht import Ring
    from repro_torch.engine import FaultConfig, get_problem, make_engine

    if world and spec.get("gather_bytes"):
        from repro_torch.engine import sharded

        sharded.GATHER_BYTES = spec["gather_bytes"]

    faults = spec.get("faults")
    kw = dict(seed=spec["eng_seed"], device=dev,
              problem=get_problem(spec["problem"], **spec["problem_kw"]),
              faults=FaultConfig(**faults) if faults else None,
              **spec.get("engine", {}))
    if world:
        kw["mesh"] = True
    return make_engine("torch", Ring(np.asarray(spec["addrs"]), spec["d"]),
                       spec["data"], **kw)


def replay(eng, spec: dict, world: int = 0) -> dict:
    """Drive `eng` through the schedule as `_diff_harness.replay` does,
    with the whole state gathered after every event and after the final
    run. A resize event re-partitions a sharded engine onto the first
    min(k, `world`) ranks (`resize_mesh`; `TorchEngine` has none, as the
    harness skips it for an engine without one); a rank left without
    lanes skips the other events and records None for their boundaries,
    and returns only what it saw."""
    problem = eng.problem
    truth = lambda: int(problem.global_output(eng.data()))
    active = lambda: getattr(eng, "active", True)
    wheel, states = [], []

    def snap():
        if not active():
            wheel.append(None)
            states.append(None)
            return
        wheel.append((eng.t, eng.in_flight, eng.messages_sent, eng.deferred))
        eng.check_conservation()
        states.append(eng.global_state())

    snap()
    for ev in spec["events"]:
        if ev[0] == "resize":
            if hasattr(eng, "resize_mesh"):
                eng.resize_mesh(min(ev[1], world))
        elif not active():
            pass
        elif ev[0] == "step":
            eng.step(ev[1])
        elif ev[0] == "set":
            eng.set_votes(ev[1], ev[2])
        elif ev[0] == "join":
            eng.join(ev[1], vote=ev[2])
        elif ev[0] == "leave":
            eng.leave(ev[1])
        elif ev[0] == "crash":
            eng.crash(ev[1])
        elif ev[0] == "settle":
            res = eng.run_until_converged(truth(), max_cycles=MAX_CYCLES)
            assert res["converged"] == 1.0, (ev, res)
        snap()
    if not active():
        return {"wheel": wheel, "states": states, "active": False}
    res = eng.run_until_converged(truth(), max_cycles=MAX_CYCLES)
    snap()
    assert res["converged"] == 1.0, res
    return {"cycles": int(res["cycles"]), "messages": int(res["messages"]),
            "wheel": wheel, "states": states, "n": eng.n,
            "pad": eng.pad, "outputs": eng.outputs(), "data": eng.data(),
            "dropped": eng.dropped, "lost": eng.lost_to_fault,
            "evictions": eng.evictions, "truth": truth(), "active": True}


def replay_rank(rank: int, world: int, dev, spec: dict) -> dict:
    """One rank's replay; the host readers are global on every rank, so
    each rank returns its trajectory, and rank 0 also the states."""
    background()
    out = replay(build(spec, dev, world), spec, world)
    if rank:
        out.pop("states")
    return out


def partition_rank(rank: int, world: int, dev, spec: dict, cycles: int):
    """This rank's own blocks (and replicas) on the host after the init
    storm and `cycles` cycles, and its sizes."""
    from repro_torch.engine.convert import state_to_numpy

    background()
    eng = build(spec, dev, world)
    eng.step(cycles)
    return {"state": state_to_numpy(eng._st), "lanes": eng.loc_lanes,
            "rows": eng.loc_rows}


def checks_rank(rank: int, world: int, dev, spec: dict) -> dict:
    """The sharded engine's argument checks on a group of `world` ranks
    (a power of two): a 3-rank group, and 2 lanes over `world` ranks."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_engine_group

    background()
    errs = {}
    try:
        make_engine_group(3)
    except ValueError as e:
        errs["make_engine_group(3)"] = str(e)
    group = dist.new_group([0, 1, 2])  # every rank takes part in new_group
    if rank < 3:
        from repro_torch.core.dht import Ring
        from repro_torch.engine.sharded import ShardedTorchEngine

        try:
            ShardedTorchEngine(Ring(np.asarray(spec["addrs"]), spec["d"]),
                               spec["data"], mesh=group, device=dev)
        except ValueError as e:
            errs["group of 3"] = str(e)
    n = len(spec["addrs"])
    try:  # a pad of 2 mod 4 carves 2 lanes
        build(dict(spec, engine={"pad_to": n + (2 - n) % 4}), dev, world)
    except ValueError as e:
        errs["two lanes"] = str(e)
    return errs


def problem_kw(problem) -> dict:
    """The port's `get_problem` arguments for a reference problem
    instance (read from its attributes; no jax needed)."""
    if problem.name == "mean":
        return dict(tau=float(problem.tau), scale=problem.scale)
    if problem.name == "l2":
        return dict(tau=float(problem.tau), dim=int(problem.data_width),
                    scale=problem.scale, ndirs=int(problem.U.shape[0]))
    return {}


def spec_of(sched: dict, problem, **engine) -> dict:
    """A `_diff_harness.make_schedule` schedule as plain data for the
    ranks: the ring drawn from its seed (the port's `Ring.random` is the
    reference's), `problem` the harness's instance, `engine` extra
    engine arguments. Resize events stay: the sharded engine re-partitions
    (`resize_mesh`), and the trajectory does not depend on the rank
    count."""
    from repro_torch.core.dht import Ring

    ring = Ring.random(sched["n"], sched["d"], seed=sched["ring_seed"])
    return dict(addrs=np.asarray(ring.addrs), d=sched["d"],
                problem=problem.name, problem_kw=problem_kw(problem),
                data=sched["data"], eng_seed=sched["eng_seed"],
                faults=sched["faults"], engine=engine,
                events=list(sched["events"]))


def assert_same_replay(want: dict, got: list, ctx: str) -> None:
    """Every rank's trajectory equal to the single engine's where the rank
    held lanes, and rank 0's (it always does) gathered state equal at
    every event boundary, field by field."""
    for i, (a, b) in enumerate(zip(want["states"], got[0]["states"])):
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (
                f"{ctx}: field {k!r} differs after event {i}")
    assert len(want["states"]) == len(got[0]["states"]), ctx
    assert got[0]["active"], ctx
    for r, g in enumerate(got):
        assert len(g["wheel"]) <= len(want["wheel"]), (ctx, r)
        for i, w in enumerate(g["wheel"]):
            assert w is None or w == want["wheel"][i], (ctx, r, i, w)
        if not g["active"]:
            continue
        assert len(g["wheel"]) == len(want["wheel"]), (ctx, r)
        for k in ("cycles", "messages", "n", "pad", "dropped", "lost",
                  "evictions", "truth"):
            assert g[k] == want[k], (ctx, r, k, want[k], g[k])
        for k in ("outputs", "data"):
            assert np.array_equal(g[k], want[k]), (ctx, r, k)


def tree_rank(rank: int, world: int, dev, xs: dict, sizes) -> dict:
    """`core.tree_collectives` on groups of the first P ranks for each P
    in `sizes` (the whole world for P = world, else a `dist.new_group`):
    ``{(P, dtype, op): this rank's result}`` on the host, for every
    dtype's (world, ...) array in `xs` (bfloat16 travels as its int16 bit
    patterns)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import tree_collectives as T

    background()
    out = {}
    for p in sizes:
        group = dist.group.WORLD if p == world else dist.new_group(
            list(range(p)))
        if rank >= p:
            continue
        for name, arr in xs.items():
            x = torch.from_numpy(np.ascontiguousarray(arr[rank]))
            if name == "bfloat16":
                x = x.view(torch.bfloat16)
            x = x.to(dev)
            for op, fn in (("reduce", T.tree_reduce),
                           ("broadcast", T.tree_broadcast),
                           ("all_reduce", T.tree_all_reduce)):
                y = fn(x, group).cpu()
                out[(p, name, op)] = (y.view(torch.int16).numpy()
                                      if name == "bfloat16" else y.numpy())
    return out


def serve_replay(eng, sched: dict, lead: bool = True) -> dict:
    """A serve schedule (`_diff_harness.make_serve_schedule`, plain data)
    through a `ThresholdServer` over `eng`: the workload's churn, submits
    and pumps on the leading server (the only one over a single engine;
    rank 0 over a sharded one, the others `follow()`), then the
    reconvergence. Returns the transition stream, the trace without its
    wall-clock fields, the serve counters and the end state."""
    from repro_torch.launch.serve import ThresholdServer, replay_workload

    server = ThresholdServer(eng, window=sched["workload"]["window_cycles"])
    transitions = []
    server.subscribe(lambda tr: transitions.append(
        (tr.t, tuple(sorted(tr.peers)), tr.output)))
    if lead:
        replay_workload(server, sched["workload"])
        server.close()
    else:
        server.follow()
    truth = int(eng.problem.global_output(eng.data()))
    res = eng.run_until_converged(truth, max_cycles=MAX_CYCLES)
    assert res["converged"] == 1.0 and server.truth == truth, res
    st = server.stats()
    return {"transitions": transitions if lead else None,
            "trace": [{k: v for k, v in r.items() if "wall" not in k}
                      for r in server.trace],
            "serve": {k: st[k] for k in ("submitted", "coalesced", "applied",
                                         "stale_dropped", "flushes",
                                         "windows", "transitions")},
            "cycles": int(res["cycles"]), "messages": eng.messages_sent,
            "outputs": eng.outputs(), "data": eng.data(),
            "addrs": np.asarray(eng.ring.addrs), "state": eng.global_state()}


def bridge_log(eng) -> tuple:
    """`EngineSuspicionBridge` over an armed `eng` (16 peers, suspect 10,
    evict 80) through a crash, as the reference's bridge test: every
    sync's plans and suspects, the monitor's table and the evictions."""
    from repro_torch.runtime.fault_tolerance import (EngineSuspicionBridge,
                                                     HeartbeatMonitor,
                                                     RestartPolicy)

    v = np.asarray(eng.votes())
    eng.run_until_converged(truth=int(2 * v.sum() > eng.ring.n),
                            max_cycles=5000)
    bridge = EngineSuspicionBridge(monitor=HeartbeatMonitor(timeout_s=40.0),
                                   policy=RestartPolicy(max_restarts=1))
    log = [(bridge.sync(eng), bridge.suspects(eng))]
    eng.crash(5)
    eng.step(60)
    log.append((bridge.sync(eng), bridge.suspects(eng)))
    while not eng.evictions:
        eng.step(16)
    log.append((bridge.sync(eng), bridge.suspects(eng)))
    return log, dict(bridge.monitor.last_seen), eng.evictions


def bridge_engine(dev, mesh=None):
    from repro_torch.core.dht import Ring
    from repro_torch.engine import FaultConfig, make_engine

    kw = {} if mesh is None else {"mesh": mesh}
    return make_engine("torch", Ring.random(16, 10, seed=7),
                       (np.arange(16) % 3 == 0).astype(np.int64), seed=0,
                       device=dev, faults=FaultConfig(suspect_after=10,
                                                      evict_after=80), **kw)


def control_rank(rank: int, world: int, dev, resize_spec: dict,
                 serve_sched: dict) -> dict:
    """The control plane on one spawn of `world` (4) ranks:

      * "resize": `resize_spec` replayed on the sharded engine over all
        ranks, its resize events re-partitioning it (4 -> 2 -> 4 -> 1 ...);
      * "serve": `serve_sched` through a `ThresholdServer` over the sharded
        engine of ranks 0 and 1 (a `dist.new_group`), rank 0 leading;
      * "bridge": the suspicion bridge over an armed sharded engine of
        every rank."""
    import torch.distributed as dist

    from repro_torch.core.dht import Ring
    from repro_torch.engine import get_problem, make_engine

    background()
    out = {"resize": replay(build(resize_spec, dev, world), resize_spec,
                            world)}
    if rank:
        out["resize"].pop("states")
    pair = dist.new_group([0, 1])
    if rank < 2:
        s = serve_sched
        eng = make_engine("torch", Ring(np.asarray(s["addrs"]), s["d"]),
                          s["data"], seed=s["eng_seed"], device=dev,
                          problem=get_problem(s["problem"],
                                              **s["problem_kw"]),
                          mesh=pair)
        out["serve"] = serve_replay(eng, s, lead=rank == 0)
    out["bridge"] = bridge_log(bridge_engine(dev, mesh=True))
    return out
