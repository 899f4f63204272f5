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


def replay(eng, spec: dict) -> dict:
    """Drive `eng` through the schedule as `_diff_harness.replay` does
    (a resize event changes nothing: the port has no `resize_mesh`), with
    the whole state gathered after every event and after the final run."""
    problem = eng.problem
    truth = lambda: int(problem.global_output(eng.data()))
    wheel, states = [], []

    def snap():
        wheel.append((eng.t, eng.in_flight, eng.messages_sent, eng.deferred))
        eng.check_conservation()
        states.append(eng.global_state())

    snap()
    for ev in spec["events"]:
        if ev[0] == "step":
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
    res = eng.run_until_converged(truth(), max_cycles=MAX_CYCLES)
    snap()
    assert res["converged"] == 1.0, res
    return {"cycles": int(res["cycles"]), "messages": int(res["messages"]),
            "wheel": wheel, "states": states, "n": eng.n,
            "pad": eng.pad, "outputs": eng.outputs(), "data": eng.data(),
            "dropped": eng.dropped, "lost": eng.lost_to_fault,
            "evictions": eng.evictions, "truth": truth()}


def replay_rank(rank: int, world: int, dev, spec: dict) -> dict:
    """One rank's replay; the host readers are global on every rank, so
    each rank returns its trajectory, and rank 0 also the states."""
    background()
    out = replay(build(spec, dev, world), spec)
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
    engine arguments. Resize events are left out: the port has no
    `resize_mesh`, and the reference's trajectory does not depend on the
    mesh size."""
    from repro_torch.core.dht import Ring

    ring = Ring.random(sched["n"], sched["d"], seed=sched["ring_seed"])
    return dict(addrs=np.asarray(ring.addrs), d=sched["d"],
                problem=problem.name, problem_kw=problem_kw(problem),
                data=sched["data"], eng_seed=sched["eng_seed"],
                faults=sched["faults"], engine=engine,
                events=[e for e in sched["events"] if e[0] != "resize"])


def assert_same_replay(want: dict, got: list, ctx: str) -> None:
    """Every rank's trajectory equal to the single engine's, and rank 0's
    gathered state equal at every event boundary, field by field."""
    for i, (a, b) in enumerate(zip(want["states"], got[0]["states"])):
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (
                f"{ctx}: field {k!r} differs after event {i}")
    assert len(want["states"]) == len(got[0]["states"]), ctx
    for r, g in enumerate(got):
        for k in ("cycles", "messages", "wheel", "n", "pad", "dropped",
                  "lost", "evictions", "truth"):
            assert g[k] == want[k], (ctx, r, k, want[k], g[k])
        for k in ("outputs", "data"):
            assert np.array_equal(g[k], want[k]), (ctx, r, k)
