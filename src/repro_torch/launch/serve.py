"""Streaming serve layer for the port's threshold engines.

The counterpart of `repro.launch.serve` (DESIGN.md §11), the same host
code over the port's engines: clients stream per-peer data updates and
subscribe to threshold-decision changes, while the engine (the port's
`TorchEngine` on the GPU, or its host `NumpyEngine`) keeps re-converging
with local communication.

Three host-side pieces around one `MajorityEngine`:

  * **`IngestionRing`** — the async ingestion buffer. `submit(addr,
    value)` is lock-protected and non-blocking (callable from any
    thread or an asyncio executor), and updates are coalesced
    *last-writer-wins per peer* between supersteps: the ring keeps one
    slot per DHT address, so a peer streaming faster than the serve
    window only costs one row per flush. Peers are keyed by ring
    ADDRESS, not index — addresses are the stable identity across
    churn, and the flush resolves them against the live ring (updates
    for departed peers are counted `stale_dropped`, never applied).
  * **`ThresholdServer.pump()`** — one serve superstep: drain the ring,
    apply the batch through the backend-uniform `engine.apply_coalesced`
    (ONE batched `set_votes` riding the wheel's full-width event-react
    path), advance the engine one window of cycles, then publish
    decision changes. The superstep-boundary flush invariant: client
    writes NEVER land mid-cycle — the engine only ever sees data change
    at a cycle boundary, which is exactly the event model the engines'
    trajectory-parity contract is defined over.
  * **`DecisionNotifier`** — diffs the per-peer 0/1 outputs against the
    previous window and publishes `(t, peer_set, output)` transitions
    (one per new output value, `peer_set` = the flipped addresses) to
    every subscriber callback. Joined peers' first outputs are
    transitions; departed peers are pruned silently.

Latency accounting (the reference's
`runtime.elastic.decision_latency_profile(trace=...)` reads it): the server
opens a *disturbance epoch* at the first flush (or churn upcall) that
leaves the engine outputs off the current ground-truth decision, and
closes it — emitting a `settle` trace record with the latency in
cycles and wall ms — at the first window boundary where every peer
again outputs the truth of the *current* data plane. Overlapping
disturbances merge into the open epoch (latency is measured from the
oldest unserved disturbance — the honest tail). Resolution is one
serve window.

Over the sharded engine (`engine.sharded.ShardedTorchEngine`, one process
a rank) a `ThresholdServer` runs on every rank of the engine's group and
rank 0 is the front end: it alone owns the ingestion ring and takes
client calls, and it relays each churn upcall and each window's drained
batch to the other ranks (one `broadcast_object_list` a call), whose
servers run `follow()` until rank 0's `close()`. Every rank thus makes
the same engine calls, and so the same collectives, in the same order;
its notifier and trace equal those of a server over `TorchEngine`.

The deterministic workload generator (`gen_workload` /
`replay_workload`) drives the same API from seeded per-window Poisson
schedules; the same trace replays bit-identically through the port's
engines and the reference's (`tests/test_torch_serve.py`).

Demo: PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \
    --n 4096 (add --device cpu without a GPU) replays one workload and
prints the server's counters and settle latencies.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class Transition(NamedTuple):
    """One published decision change: at cycle `t`, every address in
    `peers` started outputting `output`."""

    t: int
    peers: frozenset
    output: int


class IngestionRing:
    """Last-writer-wins per-peer update buffer between supersteps.

    One slot per DHT address: `submit` overwrites the pending value (a
    coalesce), `drain` atomically swaps the slot map out and returns the
    final values in ascending address order. All counters are
    monotonic; `coalesced` counts submits that overwrote a pending
    value — `submitted == coalesced + flushed + pending`.
    """

    def __init__(self):
        self._slots: Dict[int, object] = {}
        self._lock = threading.Lock()
        self.submitted = 0   # every submit() accepted
        self.coalesced = 0   # submits that overwrote a pending value
        self.flushed = 0     # values handed to drain()

    def submit(self, addr: int, value) -> None:
        addr = int(addr)
        with self._lock:
            if addr in self._slots:
                self.coalesced += 1
            self._slots[addr] = value
            self.submitted += 1

    def drain(self) -> List[Tuple[int, object]]:
        """Swap out and return the pending batch, addresses ascending."""
        with self._lock:
            slots, self._slots = self._slots, {}
            self.flushed += len(slots)
        return sorted(slots.items())

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._slots)


class DecisionNotifier:
    """Publishes per-window decision changes to subscriber callbacks.

    Tracks the last published output per ADDRESS; `publish` diffs the
    current (addrs, outputs) snapshot against it and emits one
    `Transition` per new output value whose peer set is non-empty. A
    subscriber is any callable taking a `Transition`; subscriptions are
    identified by the integer handle `subscribe` returns.
    """

    def __init__(self):
        # the last published snapshot, sorted by address
        self._addrs = np.zeros(0, np.uint64)
        self._outs = np.zeros(0, np.int64)
        self._subs: Dict[int, Callable[[Transition], None]] = {}
        self._next_sub = 0
        self.published = 0   # transitions emitted
        self.delivered = 0   # subscriber callbacks invoked

    def subscribe(self, callback: Callable[[Transition], None]) -> int:
        sid = self._next_sub
        self._next_sub += 1
        self._subs[sid] = callback
        return sid

    def unsubscribe(self, sid: int) -> None:
        self._subs.pop(sid, None)

    @property
    def subscribers(self) -> int:
        return len(self._subs)

    def publish(self, t: int, addrs: np.ndarray,
                outputs: np.ndarray) -> List[Transition]:
        """Diff the snapshot against the last published outputs; emit
        and deliver the transitions. New addresses (joiners) transition
        to their first output; departed addresses are pruned. One
        search of the snapshot's addresses in the last one's."""
        addrs = np.asarray(addrs).astype(np.uint64)
        outputs = np.asarray(outputs).astype(np.int64)
        changed = np.ones(addrs.size, bool)
        if self._addrs.size:
            pos = np.minimum(np.searchsorted(self._addrs, addrs),
                             self._addrs.size - 1)
            changed = ((self._addrs[pos] != addrs)
                       | (self._outs[pos] != outputs))
        order = np.argsort(addrs, kind="stable")
        self._addrs, self._outs = addrs[order], outputs[order]
        out = [Transition(int(t), frozenset(
                   addrs[changed & (outputs == o)].tolist()), int(o))
               for o in np.unique(outputs[changed])]
        for tr in out:
            self.published += 1
            for cb in list(self._subs.values()):
                cb(tr)
                self.delivered += 1
        return out


class ThresholdServer:
    """The streaming serve loop around one engine (module docstring).

    `window` is the serve superstep length in cycles: every `pump()` is
    flush -> `engine.step(window)` -> publish. The engine must be a
    single-trial `MajorityEngine` with `apply_coalesced` (both of the
    port's backends and the sharded engine; `batch=` engines are
    rejected — one server serves one monitoring instance). Over a
    sharded engine, rank 0's server takes the client calls and the
    others `follow()` it (module docstring).
    """

    def __init__(self, engine, window: int = 8,
                 clock: Callable[[], float] = time.perf_counter):
        if not hasattr(engine, "apply_coalesced"):
            raise TypeError(
                f"engine {type(engine).__name__} has no apply_coalesced — "
                "the serve layer needs a single-trial numpy or torch "
                "engine")
        self.engine = engine
        self.window = int(window)
        self.clock = clock
        self.ring_buf = IngestionRing()
        self.notifier = DecisionNotifier()
        self.trace: List[Dict] = []
        self.flushes = 0          # pump() calls
        self.applied = 0          # peer rows applied across all flushes
        self.stale_dropped = 0    # updates whose address had departed
        self.windows = 0
        # ground truth is maintained incrementally against a host-side
        # mirror of the quantized data plane — the additive payload
        # (sum(data), count) moves by (new - old) per applied row and by
        # one row per churn event, so pump() never reads the device
        # data plane back
        self._data = np.asarray(engine.data(), np.int64).copy()
        self._ksum = self._data.sum(0)
        self._count = self._data.shape[0]
        self._truth = self._compute_truth()
        self._dirty = False       # disturbance since the last window
        self._epoch_t0: Optional[int] = None
        self._epoch_wall: Optional[float] = None
        self.converged = True
        # a sharded engine: rank 0 relays its calls to the other ranks
        self._group = engine.group if getattr(engine, "sharded", False) \
            else None
        self.lead = True
        if self._group is not None:
            import torch.distributed as dist

            self.lead = dist.get_rank(self._group) == 0
            if dist.get_world_size(self._group) == 1:
                self._group = None  # nobody to relay to

    # -- the relay to the other ranks of a sharded engine --------------------

    def _relay(self, *cmd):
        """Rank 0: hand `cmd` to the following ranks (a no-op without
        any); a follower may not take client calls."""
        if self._group is None:
            return
        if not self.lead:
            raise RuntimeError(
                f"{cmd[0]}: rank 0's server takes the client calls; this "
                "rank's server runs follow()")
        self._broadcast(cmd)

    def _broadcast(self, cmd=None):
        import torch.distributed as dist

        box = [cmd]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self._group, 0), group=self._group)
        return box[0]

    def follow(self) -> None:
        """A following rank's loop: apply rank 0's relayed calls until its
        `close()`."""
        if self.lead:
            raise RuntimeError("rank 0's server leads; follow() is for the "
                               "other ranks")
        while True:
            cmd = self._broadcast()
            if cmd[0] == "close":
                return
            if cmd[0] == "join":
                self._join(*cmd[1:])
            elif cmd[0] == "leave":
                self._leave_addr(cmd[1])
            else:
                self._pump(*cmd[1:])

    def close(self) -> None:
        """Rank 0: release the following ranks from `follow()` (a no-op
        on an engine that is not sharded)."""
        self._relay("close")

    # -- client API ----------------------------------------------------------

    def submit(self, addr: int, value) -> None:
        """Queue one data update for the peer at `addr` (raw problem
        units: scalar for D=1 problems, a (D,) vector otherwise).
        Non-blocking; coalesced last-writer-wins until the next pump."""
        if not self.lead:
            raise RuntimeError("submit: rank 0's server owns the ingestion "
                               "ring")
        self.ring_buf.submit(addr, value)

    def subscribe(self, callback: Callable[[Transition], None]) -> int:
        return self.notifier.subscribe(callback)

    def unsubscribe(self, sid: int) -> None:
        self.notifier.unsubscribe(sid)

    # -- churn (synchronous Alg. 2 upcalls, not coalesced) -------------------

    def join(self, addr: int, value=0) -> int:
        """A peer joins at `addr` with initial data `value` (Alg. 2)."""
        self._relay("join", addr, value)
        return self._join(addr, value)

    def _join(self, addr: int, value) -> int:
        k = self.engine.join(int(addr), vote=value)
        row = self.engine.problem.peer_data(value)
        self._data = np.insert(self._data, k, row, axis=0)
        self._ksum = self._ksum + row
        self._count += 1
        self._mark_disturbed()
        return k

    def leave_addr(self, addr: int) -> None:
        """The peer at `addr` departs (Alg. 2)."""
        self._relay("leave", addr)
        self._leave_addr(addr)

    def _leave_addr(self, addr: int) -> None:
        idx = self._resolve(np.asarray([addr]))[0]
        if idx < 0:
            raise KeyError(f"no live peer at address {addr}")
        row = self._data[idx]
        self.engine.leave(int(idx))
        self._data = np.delete(self._data, idx, axis=0)
        self._ksum = self._ksum - row
        self._count -= 1
        self._mark_disturbed()

    # -- the serve superstep -------------------------------------------------

    def pump(self, cycles: Optional[int] = None) -> List[Transition]:
        """One serve superstep: flush the ingestion ring at the cycle
        boundary, advance `cycles` (default: the server window), publish
        decision changes, account latency. Returns the transitions."""
        wall0 = self.clock()
        batch = self.ring_buf.drain()
        self._relay("pump", batch, cycles)
        return self._pump(batch, cycles, wall0)

    def _pump(self, batch, cycles: Optional[int],
              wall0: Optional[float] = None) -> List[Transition]:
        wall0 = self.clock() if wall0 is None else wall0
        t0 = int(self.engine.t)
        applied = 0
        if batch:
            addrs = np.asarray([a for a, _ in batch], np.int64)
            idx = self._resolve(addrs)
            live = idx >= 0
            self.stale_dropped += int((~live).sum())
            if live.any():
                vals = _stack_values([v for (_, v), ok in zip(batch, live)
                                      if ok])
                li = idx[live]
                applied = self.engine.apply_coalesced(li, vals)
                new = self.engine.problem.init_state(vals)
                self._ksum = self._ksum + (new - self._data[li]).sum(0)
                self._data[li] = new
                self._truth = self._compute_truth()
                self._dirty = True
        self.flushes += 1
        self.applied += applied
        self.trace.append({"kind": "flush", "t": t0, "applied": applied,
                           "submitted": len(batch), "wall": wall0})

        self.engine.step(int(cycles if cycles is not None else self.window))
        self.windows += 1

        t1 = int(self.engine.t)
        wall1 = self.clock()
        outputs = np.asarray(self.engine.outputs(), np.int64)
        transitions = self.notifier.publish(
            t1, np.asarray(self.engine.ring.addrs), outputs)
        for tr in transitions:
            self.trace.append({"kind": "transition", "t": tr.t,
                               "peers": len(tr.peers), "output": tr.output,
                               "wall": wall1})
        conv = bool(self.engine.problem.converged(
            np, outputs, self._truth).all())
        if self._dirty and not conv and self._epoch_t0 is None:
            # the disturbance registered pre-step at t0/wall0: the epoch
            # opens at the boundary the data changed, not where we
            # noticed
            self._epoch_t0, self._epoch_wall = t0, wall0
        if conv:
            if self._epoch_t0 is not None:
                self.trace.append({
                    "kind": "settle", "t": t1,
                    "cycles": t1 - self._epoch_t0,
                    "wall_ms": (wall1 - self._epoch_wall) * 1e3,
                })
                self._epoch_t0 = self._epoch_wall = None
            self._dirty = False
        self.converged = conv
        return transitions

    def run(self, windows: int) -> None:
        for _ in range(windows):
            self.pump()

    # -- state ---------------------------------------------------------------

    @property
    def settled(self) -> bool:
        """No open disturbance epoch, outputs on the current truth."""
        return self.converged and self._epoch_t0 is None and not self._dirty

    @property
    def truth(self) -> int:
        """Current ground-truth decision of the live data plane."""
        return self._truth

    def stats(self) -> Dict:
        r = self.ring_buf
        return {
            "submitted": r.submitted,
            "coalesced": r.coalesced,
            "applied": self.applied,
            "stale_dropped": self.stale_dropped,
            "flushes": self.flushes,
            "windows": self.windows,
            "coalescing_ratio": round(r.submitted / self.applied, 4)
            if self.applied else 1.0,
            "transitions": self.notifier.published,
            "subscriber_deliveries": self.notifier.delivered,
            "backlog": r.pending,
            "dropped": int(np.asarray(self.engine.dropped).sum()),
        }

    def _mark_disturbed(self) -> None:
        self._truth = self._compute_truth()
        self._dirty = True

    def _compute_truth(self) -> int:
        pay = np.concatenate([self._ksum, [np.int64(self._count)]])
        return int(self.engine.problem.margin(np, pay) >= 0)

    def _resolve(self, addrs: np.ndarray) -> np.ndarray:
        """Addresses -> live ring indices (-1 where departed)."""
        ra = self.engine.ring.addrs
        a = addrs.astype(ra.dtype)
        idx = np.searchsorted(ra, a)
        ok = (idx < ra.size) & (ra[np.minimum(idx, ra.size - 1)] == a)
        return np.where(ok, idx, -1).astype(np.int64)


class ServeLoop:
    """Minimal continuous-pump driver: a daemon thread calling
    `server.pump()` until stopped, so `submit`/`subscribe` callers never
    block on the engine. A network front end (HTTP/gRPC/asyncio) wraps
    exactly this pair: thread-safe `submit` + a pump loop."""

    def __init__(self, server: ThresholdServer):
        self.server = server
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServeLoop":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            self.server.pump()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


# -- deterministic workloads -------------------------------------------------

def _raw_value(problem_name: str, rng: np.random.Generator, params: Dict):
    """One raw client value in problem units (JSON-serializable)."""
    if problem_name == "majority":
        return int(rng.integers(0, 2))
    if problem_name == "mean":
        return float(rng.normal(params["off"], 0.8))
    return [float(v) for v in rng.normal(params["center"], 0.25, size=2)]


def workload_params(problem_name: str, rng: np.random.Generator) -> Dict:
    """Per-workload value-distribution parameters, drawn once so the
    stream stays comfortably off the threshold margin (the diff-harness
    convergence-by-construction contract)."""
    if problem_name == "mean":
        return {"off": float(rng.choice([-0.6, 0.6]))}
    if problem_name == "l2":
        c = rng.normal(size=2)
        c *= float(rng.choice([0.2, 1.8])) / max(float(np.linalg.norm(c)),
                                                 1e-9)
        return {"center": [float(v) for v in c]}
    return {}


def gen_workload(ring, problem_name: str = "majority", windows: int = 24,
                 seed: int = 0, rate: float = 6.0, p_churn: float = 0.0,
                 window_cycles: int = 6, p_flip_sub: float = 0.0) -> Dict:
    """Seeded per-window serve workload over `ring`'s address space.

    Each window carries ~Poisson(`rate`) update submits (targets drawn
    WITH replacement, so windows exercise the coalescer), optional churn
    (one join or leave with probability `p_churn`, tracked against the
    live address set so every event is valid at replay time), and
    optional subscribe/unsubscribe flips. Fully deterministic in `seed`
    and cycle-clocked — the same trace replays bit-identically through
    any backend.
    """
    rng = np.random.default_rng(seed)
    params = workload_params(problem_name, rng)
    addrs = [int(a) for a in ring.addrs]
    occupied = set(addrs)
    out = []
    for _ in range(int(windows)):
        churn: List[Tuple] = []
        if rng.random() < p_churn:
            if len(addrs) <= 8 or rng.random() < 0.5:
                while True:
                    a = int(rng.integers(1, 1 << 16))
                    if a not in occupied:
                        break
                occupied.add(a)
                churn.append(("join", a, _raw_value(problem_name, rng,
                                                    params)))
                addrs.append(a)
            else:
                a = addrs.pop(int(rng.integers(len(addrs))))
                occupied.discard(a)
                churn.append(("leave", a))
        k = int(rng.poisson(rate))
        submits = [(addrs[int(rng.integers(len(addrs)))],
                    _raw_value(problem_name, rng, params))
                   for _ in range(k)]
        out.append({"churn": churn, "submits": submits,
                    "sub_flip": bool(rng.random() < p_flip_sub)})
    return {"problem": problem_name, "seed": int(seed),
            "window_cycles": int(window_cycles), "windows": out}


def replay_workload(server: ThresholdServer, workload: Dict,
                    after_pump: Optional[Callable[[int], None]] = None,
                    ) -> None:
    """Drive `server` through a `gen_workload` trace: churn upcalls,
    then submits, then one pump per window. `after_pump(i)` runs after
    each window (a parity check snapshots wheel occupancy and runs
    `check_conservation` there — after every flush)."""
    counts: List[int] = []
    sub_id = None
    for i, win in enumerate(workload["windows"]):
        if win.get("sub_flip"):
            if sub_id is None:
                sub_id = server.subscribe(lambda tr: counts.append(
                    len(tr.peers)))
            else:
                server.unsubscribe(sub_id)
                sub_id = None
        for op in win["churn"]:
            if op[0] == "join":
                server.join(op[1], op[2])
            else:
                server.leave_addr(op[1])
        for addr, val in win["submits"]:
            server.submit(addr, val)
        server.pump(workload["window_cycles"])
        if after_pump is not None:
            after_pump(i)


def _stack_values(values: List) -> np.ndarray:
    """Raw client values -> the (k,) or (k, D) array `set_votes` takes."""
    first = np.asarray(values[0])
    if first.ndim == 0:
        return np.asarray(values)
    return np.stack([np.asarray(v) for v in values])


def settle_latencies(trace: List[Dict]) -> Dict:
    """p50 / p95 / max of the trace's settle records, in cycles and wall
    ms (None without one)."""
    rec = [r for r in trace if r["kind"] == "settle"]
    out = {"decisions": len(rec)}
    for unit, key in (("cycles", "cycles"), ("ms", "wall_ms")):
        v = np.asarray([r[key] for r in rec], np.float64)
        for name, q in (("p50", 50), ("p95", 95), ("max", 100)):
            out[f"{unit}_{name}"] = (float(np.percentile(v, q)) if v.size
                                     else None)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        description="serve demo: replay one seeded workload (update "
        "submits, churn, subscriber flips) through a ThresholdServer over "
        "the port's engine")
    ap.add_argument("--backend", default="torch", choices=("numpy", "torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises without it)")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--windows", type=int, default=24)
    ap.add_argument("--rate", type=float, default=64.0,
                    help="mean update submits per window")
    ap.add_argument("--p-churn", type=float, default=0.25)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--capacity-per-peer", type=int, default=8)
    ap.add_argument("--problem", default="majority",
                    choices=("majority", "mean", "l2"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.dht import Ring
    from repro_torch.engine import make_engine

    rng = np.random.default_rng(args.seed)
    params = workload_params(args.problem, rng)
    ring = Ring.random(args.n, 32, seed=args.seed)
    data = (np.asarray([_raw_value(args.problem, rng, params)
                        for _ in range(args.n)])
            if args.problem != "majority"
            else (rng.random(args.n) < 0.4).astype(np.int64))
    kw = {"problem": args.problem}
    if args.backend == "torch":
        kw.update(device=args.device,
                  capacity_per_peer=args.capacity_per_peer)
    eng = make_engine(args.backend, ring, data, seed=args.seed + 1, **kw)
    server = ThresholdServer(eng, window=args.window)
    server.pump()
    while not server.settled:  # the init storm, off the clock
        server.pump()
    server.trace.clear()
    work = gen_workload(ring, args.problem, windows=args.windows,
                        seed=args.seed + 3, rate=args.rate,
                        p_churn=args.p_churn, window_cycles=args.window)
    t0 = time.perf_counter()
    replay_workload(server, work)
    while not server.settled:
        server.pump()
    elapsed = time.perf_counter() - t0
    rec = {"backend": args.backend, "n": args.n, "elapsed_s": elapsed,
           "updates_per_sec": server.ring_buf.submitted / max(elapsed, 1e-9),
           **server.stats(), **settle_latencies(server.trace)}
    for k, v in rec.items():
        print(f"[serve] {k} = {v}")
    return rec


if __name__ == "__main__":
    main()
