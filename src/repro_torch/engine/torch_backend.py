"""Device-resident threshold engine on PyTorch (single device).

The counterpart of `repro.engine.jax_backend.JaxEngine`: the
owner-partitioned delivery wheel, the superstep cycle
(`_cycle` ≙ ``_cycle_impl``), the full-width event react (init storm,
`set_votes` / `apply_coalesced`), Alg. 2 churn (`join` / `leave`: row
shift, R3 fence and owner re-laning, movers, routed ALERTs, and the
re-pad `_grow`), the step and convergence loops, the counters and the
conservation check, for every problem of `engine.problems` (majority,
mean, L2). For the same ring, data, seed and sizing, the state after
every cycle and every join/leave is bit-identical to
``JaxEngine(kernel="ref", wheel_kernels="none")``.

How the JAX program maps onto eager PyTorch:

  * addresses and wheel rows are uint32 in JAX; here they are int64
    holding the same values (CPU torch has no uint32 arithmetic), masked
    to 32 bits wherever the reference wraps (`_hash_u32`, ``t + delay``,
    the address algebra);
  * JAX arrays are immutable; this engine updates its state IN PLACE
    (the wheel alone is ~1 GB at n = 1e6), so `DeviceState` is one fixed
    record of tensors. The reference's dropping scatters
    (``.at[].set(mode="drop")``) write their sentinel index into one
    extra row that the storage of `inbox`, `out`, `wheel` and `awheel`
    carries past the end of the state's view;
  * the cycle counter `t`, the event counter and the enqueue salt are
    mirrored on the host (they advance deterministically), so slot
    selection and the per-cycle permutation index are host integers and
    a disarmed cycle runs without any host sync. An armed cycle makes one
    host read: the due slot's largest lane count of ALERT and PROBE rows,
    which sizes its window (the side-wheel is the reference's, sized for
    the worst probe burst). The ``lax.cond`` branches are branch-free
    here with the same bits (see `_cycle`);
  * `run_until_converged` reads the on-device convergence check once per
    cycle, in chunks of at most `CHUNK` checks (the reference's default
    dispatch boundaries; CUDA graphs and per-chunk syncing are later
    work);
  * churn is an event path: `join` / `leave` run on the device without
    reading it back; only the re-pad `_grow` copies the state to the
    host and back.

The delivery-wheel kernels (`kernels.wheel`) and `kernels.majority_step`
are called through their wrappers: on CUDA tensors they launch the
hand-written CUDA kernels. ``wheel_kernels`` names the enabled subset of
`WHEEL_KERNELS` ("auto": all; "none": every plain PyTorch version, the
parity surface); a majority engine whose subset leaves out "threshold"
runs its event react through the `majority_step` kernel, as the
reference does.

The fault plane (``faults=`` a `FaultConfig`, `crash`): a crashed peer's
rows zero and it falls silent; rows due at a dead owner are lost, data
rows are dropped or re-delayed by seeded hashes of their window index;
every accept stamps its link's `heard`; links silent past
``suspect_after`` emit PROBE rows (the HAS_EDGE flag 8) on the ALERT
side-wheel, whose accept forces an ack Send; and after every `step`
call and every convergence chunk `_fault_sweep` reads the stamps on the
host and synthesizes the Alg. 2 leave of the peer the tree neighbours
convict (`core.majority.elect_eviction`). Armed, the accept election runs
its plain version with the probe plane (``due_dedup_reference(...,
acc_p=)``), as the reference turns its fused dedup kernel off.

A trial axis (``_trials=``, built by `engine.batched.BatchedTorchEngine`)
runs B independent trials of equal (n, d) as one engine, the counterpart
of the reference's vmapped `BatchedJaxEngine`: the trials are folded into
the axes the cycle already has — peer planes (B pad, ...), link planes
(B pad 3, ...), wheels (B L, SLOTS, ...) with a trial's lanes its own
rows — so each wheel kernel launches once a cycle for all B. Owner
lookups search each trial's own address table (`_owner_of`), the R2
repair reads each trial's own ring maximum, and each trial keeps its own
cycle time, salt and delay permutations (`stack_trials` gives the
layout). `_cycle(active=)` freezes the trials that are not active: their
window is empty and nothing of theirs is written, as the reference's
``lax.cond(done, identity, _cycle_impl)`` leaves a converged trial's
state untouched. Trials are then at different t, hence due slots: the
cycle reads each lane's own slot (a gather) unless the active trials
share one. No churn or fault plane on a trial axis, as the reference;
there the single-trial entry points (`step`, `set_votes`, `join`, ...)
raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import addressing as A
from repro_torch.core import notify as N
from repro_torch.core.majority import (elect_eviction, eviction_grace,
                                       monitored_links)
from repro_torch.core.simulator import MAX_DELAY, MIN_DELAY
from repro_torch.device import resolve_device
from repro_torch.engine import protocol as P
from repro_torch.engine.base import (EngineResult, coalesced_update,
                                     run_convergence_loop)
from repro_torch.engine.problems import Majority, get_problem
from repro_torch.kernels.majority_step import (majority_step,
                                               majority_step_reference)
from repro_torch.kernels.wheel import (WHEEL_KERNELS, descent_reference,
                                       descent_tail, due_dedup,
                                       due_dedup_reference, stage_rows,
                                       stage_rows_reference, threshold_step,
                                       threshold_step_reference)
from repro_torch.kernels.wheel._common import in_segment

NDIR = 3
I32, I64 = torch.int32, torch.int64
M32 = 0xFFFFFFFF

# message-row columns: 4 router columns, P payload columns, SEQ, DELIVER_T
ORIGIN, DEST, EDGE, HAS_EDGE, PAY0 = range(5)
CONT = 2   # HAS_EDGE bit 1: the row resumes an internal descent
LATE = 4   # HAS_EDGE bit 2: the row already missed a drain window once
PROBE = 8  # HAS_EDGE bit 3: a fault-plane liveness probe (not an ALERT)
NO_ADDR = M32  # padded-ring sentinel: the row is vacant
NO_MSG = M32   # DELIVER_T sentinel: the row is dead (fenced)

SLOTS = MAX_DELAY + 1   # delivery-wheel slots
NPERM = 16              # per-cycle delay permutations kept in the state
ALERT_W = 64            # ALERT side-wheel row baseline
MAX_LANES = 8           # owner-lane count cap
CHUNK = 256             # the reference's default dispatch boundary

# fields held as uint32 by the reference (int64 here)
U32_FIELDS = frozenset({"addrs", "prev", "pos", "wheel", "awheel",
                        "salt_enq"})


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _u32(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``astype(uint32)``: int64 holding the low 32 bits."""
    return a.to(I64) & M32


def _i32(a: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 -> int32 ``astype``: two's complement of the
    low 32 bits."""
    return (((a & M32) ^ 0x80000000) - 0x80000000).to(I32)


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) without overflowing int64: the
    constant is split into 16-bit halves (works on ints and tensors)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def hash_u32(idx, t, salt):
    """The reference engine's integer mix (`jax_backend._hash_u32`) as a
    uint32 value in int64; `idx`, `t`, `salt` are ints or int tensors."""
    h = _mul32(idx & M32, 0x9E3779B1)
    h = (h + _mul32(t & M32, 0x85EBCA77) + (salt & M32)) & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def hash_delay(idx, t, salt):
    """Uniform MIN_DELAY..MAX_DELAY delay (int32) from (row, cycle, seed)."""
    span = MAX_DELAY - MIN_DELAY + 1
    return (MIN_DELAY + hash_u32(idx, t, salt) % span).to(I32)


def knowledge_outputs(problem, inbox: torch.Tensor, x: torch.Tensor,
                      pd: int) -> torch.Tensor:
    """(pd,) bool threshold outputs: the sign of margin(K), with the
    knowledge K = X_self + sum_v X_in from the flat per-link inbox."""
    pw = problem.payload_width
    k = inbox[:, :pw].reshape(pd, NDIR, pw).sum(-2, dtype=inbox.dtype)
    k = k + torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)
    return problem.margin(torch, k) >= 0


class DeviceState(NamedTuple):
    """Complete simulation state, field for field the reference's
    `jax_backend.DeviceState` (uint32 fields are int64 here). Peer rows
    are padded to `pad`; the wheel arenas and wheel counters carry a
    leading owner-lane axis. With B trials (`stack_trials`) the peer,
    link and lane axes hold the trials one after another, and the
    scalars and `perms` gain a leading (B,) axis."""

    x: torch.Tensor        # (pad, D)      int32 own data (majority: votes)
    inbox: torch.Tensor    # (pad*3, P+1)  int32 per-link [X_in payload, seq]
    out: torch.Tensor      # (pad, 3P+1)   int32 [X_out per dir]*P, seq
    addrs: torch.Tensor    # (pad,) ascending prefix then NO_ADDR
    prev: torch.Tensor     # (pad,) predecessor addresses (cyclic)
    pos: torch.Tensor      # (pad,) tree positions
    n_live: torch.Tensor   # ()     int32 occupied row count
    wheel: torch.Tensor    # (L, SLOTS, W_l, roww) data rows
    wcnt: torch.Tensor     # (L, SLOTS) int32 live rows per slot
    awheel: torch.Tensor   # (L, SLOTS, A_l, roww) Alg. 2 ALERT rows
    acnt: torch.Tensor     # (L, SLOTS) int32
    perms: torch.Tensor    # (NPERM, 10) int32 delay permutations of 1..10
    salt_enq: torch.Tensor  # () event-path delay salt
    evt_ctr: torch.Tensor  # () int32 event counter
    t: torch.Tensor        # () int32
    messages_sent: torch.Tensor  # (L,) int32 network deliveries consumed
    dropped: torch.Tensor  # (L,) int32 arena overflow (should stay 0)
    deferred: torch.Tensor  # (L,) int32 deliveries pushed past the budget
    enq: torch.Tensor      # (L,) int32 rows ever appended
    ret: torch.Tensor      # (L,) int32 rows ever drained
    dead: torch.Tensor     # (pad,) bool    crashed, not yet evicted
    heard: torch.Tensor    # (pad*3,) int32 last-accept cycle per link
    probed: torch.Tensor   # (pad*3,) int32 last-probe cycle per link
    lost: torch.Tensor     # (L,) int32     rows destroyed by injected faults


# fields stacked on a new leading trial axis; every other field is
# concatenated along its first (peer, link or lane) axis
TRIAL_STACKED = frozenset({"n_live", "perms", "salt_enq", "evt_ctr", "t"})


def stack_trials(states) -> DeviceState:
    """One B-trial state from B single-trial states of equal sizing (a
    None arena stays None)."""
    out = {}
    for k in DeviceState._fields:
        vs = [getattr(st, k) for st in states]
        if vs[0] is None:
            out[k] = None
        elif k in TRIAL_STACKED:
            out[k] = torch.stack(vs)
        else:
            out[k] = torch.cat(vs)
    return DeviceState(**out)


def trial_state(st: DeviceState, b: int, batch: int) -> DeviceState:
    """Trial `b`'s single-trial state (views) of a `batch`-trial state."""
    return DeviceState(**{
        k: (v[b] if k in TRIAL_STACKED else v.chunk(batch)[b])
        for k, v in st._asdict().items()})


class PeerPlane:
    """Access layer for the partitioned planes — the per-peer and
    per-link blocks (`x`, `inbox`, `out`, `heard`, `probed`), the
    occupancy and convergence reductions over them — and the owner-lane
    boundary of the wheel: the single-device form of the reference's
    `PeerPlane`. Every access the engine makes to those blocks goes
    through it; the replicated ring tables (`addrs`, `prev`, `pos`,
    `dead`) are read directly.

    Index contract: `idx` arguments are GLOBAL row indices (peer rows for
    `*_peer`, flat ``peer * 3 + dir`` links for `*_link`); scatters drop
    rows whose index is the sentinel (`pad` for peers, `pad * 3` for
    links) into the storage's extra row. Here global indices are tensor
    indices, every reduction is local and the exchange is the identity;
    `engine.sharded.ShardedPlane` holds one contiguous block per rank,
    and the same methods become local index translation plus the
    collectives named in each."""

    lane_base = 0  # global lane of the plane's first lane

    def __init__(self, eng: "TorchEngine"):
        self.eng = eng

    def take_peer(self, arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return arr[idx]

    def take_link(self, arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return arr[idx]

    def take_peer_rep(self, arr: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
        """Peer rows at global `idx` with a result equal on every rank
        (the churn movers, owned by any rank); event path only."""
        return arr[idx]

    def put_peer(self, name: str, idx: torch.Tensor, val) -> None:
        store = self.eng._store[name]
        store.index_put_((idx,), torch.as_tensor(val, dtype=store.dtype,
                                                 device=store.device))

    put_link = put_peer

    def link_ids(self, flat: torch.Tensor):
        """Link ids for the accept election, and the election's plane
        size: (ids in [0, nl), nl)."""
        return flat, self.eng.rows * NDIR

    def local(self, arr: torch.Tensor) -> torch.Tensor:
        """This plane's rows of a replicated per-peer table (`dead`, the
        ring tables, a full-width event mask)."""
        return arr

    def occ(self) -> torch.Tensor:
        """Occupancy of the plane's rows (global row < n)."""
        e = self.eng
        if e.batch == 1:
            return torch.arange(e.pad, device=e.device) < e.n
        return torch.arange(e.rows, device=e.device) % e.pad < e.n

    def all_true(self, ok: torch.Tensor) -> torch.Tensor:
        """(B,) AND of a per-row predicate over each trial's rows."""
        return ok.view(self.eng.batch, -1).all(1)

    def all_max(self, v: torch.Tensor) -> int:
        """Host int: the largest entry of `v` over every rank."""
        return int(v.max())

    def total(self, v: torch.Tensor) -> int:
        """Host int: the sum of a counter over every rank's lanes."""
        return int(v.sum())

    def full(self, arr: torch.Tensor) -> torch.Tensor:
        """The global table of a partitioned block (rows of every rank,
        in row order)."""
        return arr

    def exchange(self, *blocks):
        """Lane boundary exchange: each block (rows (L_loc, R, C) uint32
        values in int64, live (L_loc, R) bool, alert (L_loc, R) bool or
        None) becomes the GLOBAL lane-major (L, R, ...) block, equal on
        every rank. Identity on one device."""
        return blocks

    def shift_rows(self, arr: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """A partitioned block gathered by the GLOBAL source map `src`
        (join/leave row recompaction)."""
        return arr[src]

    def gather_events(self, *arrs):
        """The rows of an event in GLOBAL row order (the delay hash and
        the append ranks run over the whole event)."""
        return arrs


class TorchEngine:
    """Device-backed threshold engine (the `MajorityEngine` API of
    `engine.base`)."""

    backend = "torch"
    n_shards = 1  # ranks holding a block of the planes and lanes

    def __init__(self, ring, votes: Optional[np.ndarray], seed: int = 0,
                 capacity_per_peer: int = 6, work_budget: int = 0,
                 pad_to: int = 0, problem=None,
                 wheel_kernels="auto", faults=None, device="cuda",
                 _state: Optional[DeviceState] = None, _trials=None):
        if ring.d > 32:
            raise ValueError(
                f"torch engine needs d <= 32 (32-bit addresses), got d={ring.d}")
        self.problem = get_problem(problem)
        self.device = resolve_device(device)
        # the trial axis: _trials lists B (ring, votes, seed) of equal (n, d)
        self.batch = 1 if _trials is None else len(_trials)
        if _trials is not None and faults is not None:
            raise NotImplementedError("no fault plane on a trial axis")
        if wheel_kernels in ("auto", None):
            wk = WHEEL_KERNELS
        elif wheel_kernels == "none":
            wk = ()
        else:
            wk = tuple(wheel_kernels)
        bad = set(wk) - set(WHEEL_KERNELS)
        if bad:
            raise ValueError(f"unknown wheel kernels {sorted(bad)}; "
                             f"pick from {WHEEL_KERNELS}")
        # fault plane: the seeded drop/delay draws and the host eviction
        # sweep's state. Probe rows need the plain election, so the dedup
        # kernel is off while armed, as in the reference
        self._faults = faults
        self._evictions = []
        # (address, dir) -> cycle: the synchronous `heard` refresh the
        # reference simulator performs at a churn event; the routed ALERT
        # recipients' links only refresh on accept, cycles later
        self._heard_floor = {}
        self._evict_floor = -(1 << 30)  # conviction grace after evictions
        if faults is not None:
            wk = tuple(k for k in wk if k != "dedup")
            fr = np.random.default_rng(np.uint32(faults.seed) ^ 0xFA17)
            self._fsalt_drop = int(fr.integers(0, 2**32, dtype=np.uint64))
            self._fsalt_delay = int(fr.integers(0, 2**32, dtype=np.uint64))
            self._p_drop_thr = min(int(faults.p_drop * 2**32), 2**32 - 1)
            self._p_delay_thr = min(int(faults.p_delay * 2**32), 2**32 - 1)
        # each kernel's wrapper (its CUDA kernel on CUDA tensors) where
        # enabled, else its plain version — "none" is the parity surface
        pick = lambda name, kern, plain: kern if name in wk else plain
        self._stage = pick("enqueue", stage_rows, stage_rows_reference)
        self._dedup = pick("dedup", due_dedup, due_dedup_reference)
        self._descent = pick("descent", descent_tail, descent_reference)
        self._thresh = pick("threshold", threshold_step,
                            threshold_step_reference)
        # the majority event react without the threshold kernel
        self._majority_react = (isinstance(self.problem, Majority)
                                and "threshold" not in wk)
        self._majority = majority_step if wk else majority_step_reference
        self.pw = int(self.problem.payload_width)
        self.dw = int(self.problem.data_width)
        self._SEQ = PAY0 + self.pw
        self._DT = self._SEQ + 1
        self.roww = self._DT + 1
        self.ring = ring
        self.n = int(ring.n)
        self.d = int(ring.d)
        self._cpp = int(capacity_per_peer)
        self._wb_req = int(work_budget)
        self.pad = int(pad_to) or _next_pow2(max(self.n + max(8, self.n // 8),
                                                 64))
        if self.pad < self.n:
            raise ValueError(f"pad_to={pad_to} below ring size {self.n}")
        self._size_tables()
        self._plane = self._make_plane()
        if _state is not None:
            self._adopt(_state)
            return
        if _trials is None:
            _trials = [(ring, votes, seed)]
        for r, v, _ in _trials:
            if v.shape[0] != r.n:
                raise ValueError(f"{v.shape[0]} votes for {r.n} peers")
        self._adopt(stack_trials([self._initial_state(*a) for a in _trials])
                    if self.batch > 1 else self._initial_state(*_trials[0]))
        self._react(self._plane.occ())

    @classmethod
    def from_state(cls, ring, state, seed: int = 0, **sizing) -> "TorchEngine":
        """Resume from a state (a `DeviceState`, or the reference engine's
        state as a dict of numpy arrays, see `engine.convert`). `sizing`
        must match the engine that produced it (capacity_per_peer,
        work_budget, pad_to); the RNG material is the state's own,
        so `seed` changes nothing."""
        from repro_torch.engine.convert import state_from_numpy

        if isinstance(state, dict):
            state = state_from_numpy(state)
        return cls(ring, None, seed=seed, _state=state, **sizing)

    def _size_tables(self):
        """Owner lanes, drain budget and arena sizes — the reference's
        `_size_tables` formulas verbatim."""
        self.lanes = min(MAX_LANES, self.pad & -self.pad)
        self.lane_rows = self.pad // self.lanes
        # with a trial axis: B pad peer rows and B L lanes in all; of
        # those, each of the n_shards ranks holds one contiguous block
        self.rows = self.batch * self.pad
        self.nlanes = self.batch * self.lanes
        self.loc_rows = self.rows // self.n_shards
        self.loc_lanes = self.nlanes // self.n_shards
        self._lane_ar = torch.arange(self.loc_lanes, device=self.device)
        L = self.lanes
        b_req = self._wb_req or max(512, self.pad // 8)
        self.lane_budget = max(1, b_req // L)
        self.work_budget = self.lane_budget * L
        self.lane_cap = max(4, min(128, 32 * self._cpp) // min(L, 4),
                            self._cpp * self.pad // (16 * L))
        self.lane_alert_w = max(16, ALERT_W // L)
        if self._faults is not None:
            # armed: every probe in the ring can target one owner's lane
            # and slot in one cycle; size for it so none is dropped
            self.lane_alert_w = max(self.lane_alert_w, 3 * self.pad + 16)
        self.lane_width = max(self.lane_cap, self.lane_budget) + self.lane_budget
        self.window_l = self.lane_alert_w + self.lane_budget
        self.narrow_l = max(self.lane_alert_w + 8, self.window_l // 8)
        self.mig_w = max(32, self.lane_cap // 4)  # churn re-lane rows/lane

    def _initial_state(self, ring, votes: np.ndarray, seed: int) -> DeviceState:
        """Fresh state for (ring, votes, seed), before the init react; the
        RNG draws are the reference's, in its order."""
        pd, L, dev = self.pad, self.lanes, self.device
        rng = np.random.default_rng(seed)
        salt = int(rng.integers(0, 2**32, dtype=np.uint64))
        perms = np.stack([rng.permutation(10) + MIN_DELAY
                          for _ in range(NPERM)]).astype(np.int32)
        addrs = np.full(pd, NO_ADDR, np.int64)
        addrs[: self.n] = ring.addrs.astype(np.int64)
        x = np.zeros((pd, self.dw), np.int32)
        x[: self.n] = self.problem.init_state(votes).astype(np.int32)
        addrs_t = torch.from_numpy(addrs).to(dev)
        idx = torch.arange(pd, device=dev)
        prev = addrs_t[(idx - 1) % self.n]
        z = lambda *shape, dtype=I32: torch.zeros(shape, dtype=dtype, device=dev)
        return DeviceState(
            x=torch.from_numpy(x).to(dev),
            inbox=z(pd * NDIR, self.pw + 1), out=z(pd, NDIR * self.pw + 1),
            addrs=addrs_t, prev=prev,
            pos=A.position_from_segment(prev, addrs_t, self.d),
            n_live=torch.tensor(self.n, dtype=I32, device=dev),
            # the empty arenas are allocated by `_adopt` in their storage
            # (an armed side-wheel is 35 GB at n = 1e6: never twice)
            wheel=None, wcnt=z(L, SLOTS), awheel=None, acnt=z(L, SLOTS),
            perms=torch.from_numpy(perms).to(dev),
            salt_enq=torch.tensor(salt, dtype=I64, device=dev),
            evt_ctr=z(), t=z(),
            messages_sent=z(L), dropped=z(L), deferred=z(L), enq=z(L),
            ret=z(L), dead=z(pd, dtype=torch.bool), heard=z(pd * NDIR),
            probed=z(pd * NDIR), lost=z(L),
        )

    def _make_plane(self) -> PeerPlane:
        return PeerPlane(self)

    def _adopt(self, st: DeviceState) -> None:
        """Take `st` as this engine's state: copy it to the engine's device
        into storage with one sentinel row past each scattered plane (a
        None arena is allocated there empty), and mirror the host-side
        scalars."""
        dev, rows, nl = self.device, self.loc_rows, self.loc_lanes
        want = {"x": (rows, self.dw), "inbox": (rows * NDIR, self.pw + 1),
                "out": (rows, NDIR * self.pw + 1),
                "wheel": (nl, SLOTS, self.lane_width, self.roww),
                "awheel": (nl, SLOTS, self.lane_alert_w, self.roww)}
        for k, shape in want.items():
            if getattr(st, k) is None and k in ("wheel", "awheel"):
                continue
            if tuple(getattr(st, k).shape) != shape:
                raise ValueError(f"state {k} has shape {tuple(getattr(st, k).shape)}"
                                 f", this sizing wants {shape}")
        if bool((st.n_live != self.n).any()):
            raise ValueError("state n_live differs from the ring size")
        self._store = {}
        fields = {}
        for k in DeviceState._fields:
            v = getattr(st, k)
            if v is None:
                buf = torch.zeros((int(np.prod(want[k][:-1])) + 1,
                                   want[k][-1]), dtype=I64, device=dev)
                self._store[k] = buf
                fields[k] = buf[:-1].view(want[k])
                continue
            if k in ("x", "inbox", "out", "wheel", "awheel", "heard",
                     "probed"):
                # copied from wherever `st` lies straight into the storage
                rows = v.reshape(-1, v.shape[-1] if v.dim() > 1 else 1)
                buf = torch.zeros((rows.shape[0] + 1, rows.shape[1]),
                                  dtype=v.dtype, device=dev)
                buf[:-1].copy_(rows)
                self._store[k] = buf
                v = buf[:-1].view(v.shape)
            else:
                v = v.to(dev, copy=True)
            fields[k] = v
        self._st = DeviceState(**fields)
        # host mirrors: each trial's t; the event counter (equal in every
        # trial: events reach them all); the salt (of trial 0, read only
        # on one trial)
        self._tb = st.t.reshape(-1).cpu().numpy().astype(np.int64)
        self._evt = int(st.evt_ctr.reshape(-1)[0])
        self._salt = int(st.salt_enq.reshape(-1)[0])
        self._frozen = (None, None)  # (active mask bytes, its lane tensors)

    @property
    def _t(self) -> int:
        """The cycle counter (one trial; trial 0's on a trial axis)."""
        return int(self._tb[0])

    # -- shared helpers ------------------------------------------------------

    def _owner_of(self, q: torch.Tensor) -> torch.Tensor:
        """Peer row owning each address (successor with wrap): one binary
        search over the padded sorted-prefix table. On a trial axis `q` is
        B equal trial-major blocks, each searched in its own trial's table
        (one 2-D search), and the rows are global (b pad + local)."""
        if self.batch == 1:
            return torch.searchsorted(self._st.addrs, q.contiguous(),
                                      side="left") % self.n
        B, pd = self.batch, self.pad
        loc = torch.searchsorted(self._st.addrs.view(B, pd),
                                 q.reshape(B, -1).contiguous(),
                                 side="left") % self.n
        base = torch.arange(0, B * pd, pd, device=q.device)[:, None]
        return (loc + base).reshape(q.shape)

    def _lane_of(self, dest: torch.Tensor) -> torch.Tensor:
        return self._owner_of(dest) // self.lane_rows

    @staticmethod
    def _compact(mask: torch.Tensor, budget: int):
        """Indices of the first `budget` set bits of `mask` along its last
        axis (its length where exhausted), and the ordinal cumsum."""
        cum = torch.cumsum(mask.to(I32), dim=-1, dtype=I64)
        q = torch.arange(1, budget + 1, device=mask.device)
        q = q.expand(*mask.shape[:-1], budget).contiguous()
        return torch.searchsorted(cum, q, side="left"), cum

    @staticmethod
    def _group_ranks(g: torch.Tensor, live: torch.Tensor, n_groups: int):
        """Stable within-group ranks and per-group counts of a flat row
        batch: rank[i] = #live rows j < i with g[j] == g[i]."""
        m = g.shape[0]
        key = torch.where(live, g, n_groups)
        ks, order = torch.sort(key, stable=True)
        first = torch.searchsorted(ks, ks, side="left")
        rank = torch.empty_like(order)
        rank[order] = torch.arange(m, device=g.device) - first
        # group sizes from the group starts in the sorted keys (a scatter-
        # add onto the few group counters would serialize on atomics)
        starts = torch.searchsorted(
            ks, torch.arange(n_groups + 1, device=g.device), side="left")
        return rank, torch.diff(starts).to(I32)

    def _append_rows(self, name: str, cnt: torch.Tensor, rows: torch.Tensor,
                     lane: torch.Tensor, slot: torch.Tensor,
                     live: torch.Tensor, cap: int):
        """Append the GLOBAL row batch `rows` (m, roww) to the local lane
        arenas of wheel `name` (lanes from `plane.lane_base` on; a row
        of another rank's lane is not this rank's to append) at
        cnt[lane, slot] + stable rank within the (lane, slot) group;
        overflow past `cap` drops. A group lies in one lane, so ranking
        only the owned rows gives the ranks of the whole batch. Updates
        `cnt` in place and returns (attempted (L,), dropped (L,)) int32."""
        L = cnt.shape[0]
        width = self.lane_width if name == "wheel" else self.lane_alert_w
        if self.n_shards > 1:
            lane = lane - self._plane.lane_base
            live = live & (lane >= 0) & (lane < L)
        rank, counts = self._group_ranks(lane * SLOTS + slot, live, L * SLOTS)
        lsafe = torch.where(live, lane, 0)
        off = cnt[lsafe, slot] + rank
        ok = live & (off < cap)
        flat = torch.where(ok, (lsafe * SLOTS + slot) * width + off,
                           L * SLOTS * width)
        self._store[name].index_put_((flat,), rows)
        counts = counts.reshape(L, SLOTS)
        added = torch.minimum(counts, cap - cnt)
        cnt += added
        attempted = counts.sum(1, dtype=I32)
        return attempted, attempted - added.sum(1, dtype=I32)

    def _out_pay(self, out: torch.Tensor) -> torch.Tensor:
        """(..., 3P+1) out rows -> (..., 3, P) X_out payload planes."""
        return torch.stack([out[..., c * NDIR:(c + 1) * NDIR]
                            for c in range(self.pw)], dim=-1)

    def _pack_out(self, pay: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
        """Inverse of `_out_pay`: (..., 3, P) payload + (...,) seq."""
        return torch.cat([pay[..., c] for c in range(self.pw)]
                         + [seq[..., None]], dim=-1)

    def _rules(self, in_pay, out_pay, x):
        """The threshold rules: the `threshold_step` kernel, or its plain
        version when the engine's kernels are off."""
        return self._thresh(self.problem, in_pay.contiguous(),
                            out_pay.contiguous(), x.contiguous())

    def _test_phase(self):
        """Full-width threshold rules of the event react: the
        `majority_step` planes for a majority engine without the
        threshold kernel, `_rules` otherwise. Returns (viol (pd,3),
        pay (pd,3,P)) over the plane's rows."""
        st, pd, pw = self._st, self.loc_rows, self.pw
        if self._majority_react:
            plane = lambda a: a.reshape(pd, NDIR).contiguous()
            viol, _, po, pt = self._majority(
                plane(st.inbox[:, 0]), plane(st.inbox[:, 1]),
                st.out[:, 0:3].contiguous(), st.out[:, 3:6].contiguous(),
                st.x[:, 0].contiguous())
            return viol, torch.stack([po, pt], dim=-1)
        in_pay = st.inbox[:, :pw].reshape(pd, NDIR, pw)
        viol, _, pay = self._rules(in_pay, self._out_pay(st.out), st.x)
        return viol, pay

    def _outputs_match(self, truth) -> torch.Tensor:
        """The threshold convergence predicate per trial, on device ((B,)
        bool); `truth` an int, or a (B,) tensor of each trial's. A test
        of the plane's rows, then `plane.all_true`."""
        st, pl = self._st, self._plane
        out = knowledge_outputs(self.problem, st.inbox, st.x,
                                self.loc_rows).to(I32)
        if isinstance(truth, torch.Tensor):
            truth = truth.repeat_interleave(self.pad)
        ok = self.problem.converged(torch, out, truth) | ~pl.occ()
        if self._faults is not None:
            ok = ok | pl.local(st.dead)  # crashed, unevicted: no say
        return pl.all_true(ok)

    # -- event path (full-width react, ranked append, hashed delays) --------

    def _enqueue_events(self, cand, origin, dest, edge, has_edge, pay, seq,
                        alert: bool = False):
        """Append the `cand` rows of an event to the wheel of each DEST
        owner's lane, due after a per-row hashed delay; ALERT rows go to
        the side-wheel, due immediately. The rows are the GLOBAL event
        block (a full-width react gathers it first), of which each rank
        appends the rows its lanes own. On a trial axis the rows are B
        equal trial-major blocks, each hashed by its own index within the
        block, its trial's t and salt."""
        st, B = self._st, self.batch
        m = cand.shape[0]
        if alert:
            due = torch.full((m,), self._t, dtype=I32, device=self.device)
        elif B == 1:
            rix = torch.arange(m, device=self.device)
            due = self._t + hash_delay(rix, self._t + self._evt, self._salt)
        else:
            rix = torch.arange(m // B, device=self.device)[None, :]
            t = st.t.long()[:, None]
            due = (t + hash_delay(rix, t + self._evt,
                                  st.salt_enq[:, None])).reshape(-1)
        rows = torch.stack(
            [_u32(origin), _u32(dest), _u32(edge), _u32(has_edge)]
            + [_u32(pay[:, c]) for c in range(self.pw)]
            + [_u32(seq), _u32(due)], dim=1)
        name, cnt, cap = (("awheel", st.acnt, self.lane_alert_w) if alert
                          else ("wheel", st.wcnt, self.lane_cap))
        att, dro = self._append_rows(name, cnt, rows, self._lane_of(dest),
                                     due.long() % SLOTS, cand, cap)
        st.enq.add_(att)
        st.dropped.add_(dro)
        st.evt_ctr.add_(1)
        self._evt += 1

    def _react(self, touched: torch.Tensor) -> None:
        """Threshold test() + Send(v) for all `touched` peers (full-width
        event path: initialization and data changes). `touched` covers
        the plane's rows; the sends are gathered into global row order
        (`plane.gather_events`) for the append."""
        st, pd, pw, pl = self._st, self.loc_rows, self.pw, self._plane
        if self._faults is not None:
            touched = touched & ~pl.local(st.dead)  # the dead never send
        viol, pay = self._test_phase()
        eff = viol & touched[:, None]
        seq = st.out[:, NDIR * pw] + eff.any(1).to(I32)
        new_pay = torch.where(eff[..., None], pay, self._out_pay(st.out))
        st.out.copy_(self._pack_out(new_pay, seq))
        dirs = torch.arange(NDIR, device=self.device).expand(pd, NDIR)
        bc = lambda a: a[:, None].expand(pd, NDIR)
        tab = lambda a: bc(pl.local(a))
        valid, origin, dest, edge, has_edge = P.send_fields(
            tab(st.pos), dirs, tab(st.addrs), tab(st.prev), self.d)
        self._enqueue_events(*pl.gather_events(
            (eff & valid).reshape(-1), origin.reshape(-1), dest.reshape(-1),
            edge.reshape(-1), has_edge.reshape(-1), pay.reshape(-1, pw),
            bc(seq).reshape(-1)))

    # -- churn (Alg. 2) ------------------------------------------------------

    def _links(self, rows: torch.Tensor) -> torch.Tensor:
        """(r, NDIR) flat link indices of peer rows `rows`."""
        return rows[:, None] * NDIR + torch.arange(NDIR, device=self.device)

    def _shift_peer_rows(self, src: torch.Tensor) -> None:
        """Gather-shift every peer-indexed table by the source map `src`
        (join/leave row recompaction), in place: the replicated tables by
        a gather, the partitioned blocks through `plane.shift_rows`."""
        st, pl = self._st, self._plane
        link_src = self._links(src).reshape(-1)
        for name in ("addrs", "dead"):
            a = getattr(st, name)
            a.copy_(a[src])
        for name, idx in (("x", src), ("out", src), ("inbox", link_src),
                          ("heard", link_src), ("probed", link_src)):
            a = getattr(st, name)
            a.copy_(pl.shift_rows(a, idx))

    def _ring_views(self) -> None:
        """Recompute prev/pos from the padded address table (vacant rows
        hold garbage that owner lookups never reach)."""
        st = self._st
        idx = torch.arange(self.pad, device=self.device)
        st.prev.copy_(st.addrs[(idx - 1) % self.n])
        st.pos.copy_(A.position_from_segment(st.prev, st.addrs, self.d))

    def _join(self, addr: int, data: np.ndarray, k: int) -> None:
        """Insert a peer row at `k` (gather-shift of the sorted prefix +
        one row write; `data` is the joiner's (D,) data), then run the
        churn tail."""
        st, dev, pl = self._st, self.device, self._plane
        idx = torch.arange(self.pad, device=dev)
        self._shift_peer_rows(torch.where(idx <= k, idx, idx - 1))
        kt = torch.tensor([k], device=dev)
        lk = k * NDIR + torch.arange(NDIR, device=dev)
        st.addrs[k] = addr
        st.dead[k] = False
        pl.put_peer("x", kt, torch.from_numpy(data.astype(np.int32)))
        pl.put_link("inbox", lk, 0)
        pl.put_peer("out", kt, 0)
        # the joiner starts with fresh detector stamps
        pl.put_link("heard", lk, st.t)
        pl.put_link("probed", lk, st.t)
        st.n_live.add_(1)
        self.n += 1
        self._ring_views()
        n = self.n
        self._churn_tail(st.addrs[(k - 1) % n].clone(), st.addrs[k].clone(),
                         st.addrs[(k + 1) % n].clone())

    def _leave(self, k: int) -> None:
        """Delete peer row `k` (gather-shift left + sentinel the vacated
        row), then run the churn tail."""
        st, dev, nb, pl = self._st, self.device, self.n, self._plane
        a_im1 = st.addrs[k].clone()
        a_im2 = st.addrs[(k - 1) % nb].clone()
        a_i = st.addrs[(k + 1) % nb].clone()
        idx = torch.arange(self.pad, device=dev)
        self._shift_peer_rows(torch.clamp(torch.where(idx < k, idx, idx + 1),
                                          max=self.pad - 1))
        last = nb - 1  # the vacated row after the shift
        lt = torch.tensor([last], device=dev)
        ll = last * NDIR + torch.arange(NDIR, device=dev)
        st.addrs[last] = NO_ADDR
        st.dead[last] = False
        pl.put_peer("x", lt, 0)
        pl.put_peer("out", lt, 0)
        for name in ("inbox", "heard", "probed"):
            pl.put_link(name, ll, 0)
        st.n_live.sub_(1)
        self.n = last
        self._ring_views()
        self._churn_tail(a_im2, a_im1, a_i)

    def _fence_and_migrate(self, pos_fix: torch.Tensor,
                           pos_var: torch.Tensor) -> None:
        """R3 fence + owner re-laning after a membership change.

        Each lane sweeps its arenas once, slot-major: data rows whose
        origin is a change position drop (the fence; the ALERT side-wheel
        is never origin-fenced), rows still owned are compacted in place
        per slot, and rows whose DEST owner moved to another lane are
        collected (first `mig_w` per lane) and re-appended to their owner
        lane. Removed rows are retired; migrated rows re-enter through
        `enq`; a migration overflow counts in both `enq` and `dropped`.
        The sweep is lane-local; the migration blocks ride the lane
        exchange (`plane.exchange`) to their owner lanes.
        """
        st, dev, pl = self._st, self.device, self._plane
        L, roww, MW = self.loc_lanes, self.roww, self.mig_w
        lanes = torch.arange(L, device=dev) + pl.lane_base

        def sweep(buf, cnt, fence: bool):
            width = buf.shape[2]
            live = (torch.arange(width, device=dev)[None, None, :]
                    < cnt[:, :, None]).reshape(L, SLOTS * width)
            rows = buf.reshape(L, SLOTS * width, roww)
            ok = rows[:, :, self._DT] != NO_MSG
            stale = ((rows[:, :, ORIGIN] == pos_fix)
                     | (rows[:, :, ORIGIN] == pos_var))
            if fence:
                ok &= ~stale
            elif self._faults is not None:
                # the ALERT side-wheel is never origin-fenced, but the
                # probes riding it are ordinary traffic under R3
                ok &= ~(((rows[:, :, HAS_EDGE] & PROBE) != 0) & stale)
            inlane = (self._lane_of(rows[:, :, DEST].reshape(-1)).reshape(L, -1)
                      == lanes[:, None])
            keep = (live & ok & inlane).reshape(L, SLOTS, width)
            move = live & ok & ~inlane
            kidx, kcum = self._compact(keep, width)
            kidx = torch.where(kidx < width, kidx, 0)
            kept = torch.gather(buf, 2, kidx[..., None].expand(
                L, SLOTS, width, roww))
            nc = kcum[..., -1].to(I32)
            midx, mcum = self._compact(move, MW)
            mok = midx < SLOTS * width
            mig = torch.gather(rows, 1, torch.where(mok, midx, 0)[..., None]
                               .expand(L, MW, roww))
            lost = torch.clamp(mcum[:, -1] - MW, min=0).to(I32)
            removed = cnt.sum(1, dtype=I32) - nc.sum(1, dtype=I32)
            buf.copy_(kept)
            cnt.copy_(nc)
            return mig, mok, removed, lost

        def relane(name, cnt, cap, mig, mok):
            mig, mok = mig.reshape(-1, roww), mok.reshape(-1)
            lane = self._lane_of(mig[:, DEST])
            slot = _i32(mig[:, self._DT]).long() % SLOTS
            return self._append_rows(name, cnt, mig, lane, slot, mok, cap)

        mig_d, mok_d, rem_d, lost_d = sweep(st.wheel, st.wcnt, True)
        mig_a, mok_a, rem_a, lost_a = sweep(st.awheel, st.acnt, False)
        (mig_d, mok_d, _), (mig_a, mok_a, _) = pl.exchange(
            (mig_d, mok_d, None), (mig_a, mok_a, None))
        att_d, dro_d = relane("wheel", st.wcnt, self.lane_cap, mig_d, mok_d)
        att_a, dro_a = relane("awheel", st.acnt, self.lane_alert_w, mig_a,
                              mok_a)
        st.ret.add_(rem_d + rem_a)
        st.enq.add_(att_d + att_a + lost_d + lost_a)
        st.dropped.add_(dro_d + dro_a + lost_d + lost_a)

    def _churn_tail(self, a_im2, a_im1, a_i) -> None:
        """Alg. 2 after the row change (the reference's `_churn_tail`):

        1. fence + re-lane — `_fence_and_migrate`;
        2. movers — peers whose position after the change IS pos_fix or
           pos_var — zero their whole X_in and Send in every direction;
        3. the <= 6 routed ALERT rows go into the side-wheel, due now; the
           cycle delivers them through the Alg. 1 router and an accepted
           ALERT zeroes its link and forces Send.
        """
        st, pd, pw, d, dev = self._st, self.pad, self.pw, self.d, self.device
        pl = self._plane
        pos_fix, pos_var = P.change_positions(a_im2, a_im1, a_i, d)
        self._fence_and_migrate(pos_fix, pos_var)

        cp = torch.stack([pos_fix, pos_var])
        own = self._owner_of(cp)
        mover_rows = torch.where(st.pos[own] == cp, own, pd)
        mlinks = self._links(mover_rows).reshape(-1)
        pl.put_link("inbox", torch.clamp(mlinks, max=pd * NDIR), 0)
        mv = mover_rows < pd
        mp = torch.where(mv, mover_rows, 0)
        if self._faults is not None:
            mv = mv & ~st.dead[mp]  # crashed peers are silent: no sends
        # a mover's X_in is now zero, so its knowledge is K = [x, 1] (rows
        # with ~mv only ever reach the sentinel rows)
        k = torch.cat([pl.take_peer_rep(st.x, mp),
                       torch.ones((2, 1), dtype=I32, device=dev)], dim=-1)
        pay = k[:, None, :].expand(2, NDIR, pw)
        seq2 = pl.take_peer_rep(st.out, mp)[:, NDIR * pw] + 1
        pl.put_peer("out", torch.where(mv, mp, pd), self._pack_out(pay, seq2))
        dirs2 = torch.arange(NDIR, device=dev).expand(2, NDIR)
        bc2 = lambda a: a[:, None].expand(2, NDIR)
        valid, origin, dest, edge, has_edge = P.send_fields(
            bc2(st.pos[mp]), dirs2, bc2(st.addrs[mp]), bc2(st.prev[mp]), d)
        self._enqueue_events(
            (valid & bc2(mv)).reshape(-1), origin.reshape(-1),
            dest.reshape(-1), edge.reshape(-1), has_edge.reshape(-1),
            pay.reshape(-1, pw), bc2(seq2).reshape(-1))

        ap, adirs = P.alert_plan(pos_fix, pos_var)
        aown = self._owner_of(ap)
        valid, origin, dest, edge, has_edge = P.send_fields(
            ap, adirs, st.addrs[aown], st.prev[aown], d)
        if self._faults is not None:
            valid = valid & ~st.dead[aown]  # the dead emit no ALERTs
            # the movers' links are fresh news: no aging the new occupants
            # on stamps carried over from the old ones
            pl.put_link("heard", torch.where(mv.repeat_interleave(NDIR),
                                             mlinks, pd * NDIR), st.t)
        zero = torch.zeros(6, dtype=I64, device=dev)
        self._enqueue_events(valid, origin, dest, edge, has_edge,
                             zero[:, None].expand(6, pw), zero, alert=True)

    def _grow(self, need_n: int) -> None:
        """Re-pad every table one size up (host-side, as the reference):
        the lane count and boundaries move with the pad, so every live
        wheel row is re-placed in the lane owning its DEST under the new
        tables (stable (lane, slot, position) order, capped like an
        append; a truncated row counts as dropped). Per-lane counters
        collapse into lane 0. A sharded engine gathers the state to each
        rank's host, re-pads it there the same way on every rank, and
        each rank copies only its blocks to its device."""
        from repro_torch.engine.convert import state_from_numpy

        host = self.global_state()
        old_pad = self.pad
        self.pad = _next_pow2(need_n + max(8, need_n // 8))
        self._size_tables()
        pr = self.pad - old_pad

        def pad_rows(a, fill=0):
            return np.concatenate([a, np.full((pr,) + a.shape[1:], fill,
                                              a.dtype)])

        addrs = pad_rows(host["addrs"], NO_ADDR)
        n_live = int(host["n_live"])

        def collect(buf, cnt):
            out = [buf[l, s, : cnt[l, s]]
                   for l in range(buf.shape[0]) for s in range(SLOTS)]
            return np.concatenate(out)

        def place(rows, cap, width):
            buf = np.zeros((self.lanes, SLOTS, width, self.roww), np.uint32)
            cnt = np.zeros((self.lanes, SLOTS), np.int32)
            lost = 0
            if rows.shape[0]:
                own = (np.searchsorted(addrs, rows[:, DEST], side="left")
                       % n_live)
                g = ((own // self.lane_rows) * SLOTS
                     + rows[:, self._DT].astype(np.int64) % SLOTS)
                order = np.argsort(g, kind="stable")
                gs = g[order]
                rank = np.arange(len(gs)) - np.searchsorted(gs, gs, "left")
                ok = rank < cap
                li, si = gs[ok] // SLOTS, gs[ok] % SLOTS
                buf[li, si, rank[ok]] = rows[order][ok]
                np.add.at(cnt, (li, si), 1)
                lost = int((~ok).sum())
            return buf, cnt, lost

        wheel, wcnt, lost_w = place(collect(host["wheel"], host["wcnt"]),
                                    self.lane_cap, self.lane_width)
        awheel, acnt, lost_a = place(collect(host["awheel"], host["acnt"]),
                                     self.lane_alert_w, self.lane_alert_w)

        def lane0(v, extra=0):
            a = np.zeros(self.lanes, np.int32)
            a[0] = int(v.sum()) + extra
            return a

        links = lambda a: np.concatenate([a, np.zeros((pr * NDIR,)
                                                       + a.shape[1:], a.dtype)])
        new = dict(host, x=pad_rows(host["x"]), inbox=links(host["inbox"]),
                   out=pad_rows(host["out"]), addrs=addrs,
                   prev=pad_rows(host["prev"]), pos=pad_rows(host["pos"]),
                   wheel=wheel, wcnt=wcnt, awheel=awheel, acnt=acnt,
                   messages_sent=lane0(host["messages_sent"]),
                   dropped=lane0(host["dropped"], lost_w + lost_a),
                   deferred=lane0(host["deferred"]), enq=lane0(host["enq"]),
                   ret=lane0(host["ret"]), dead=pad_rows(host["dead"]),
                   heard=links(host["heard"]), probed=links(host["probed"]),
                   lost=lane0(host["lost"]))
        # built on the host: `_adopt` copies (a sharded engine: its
        # blocks of) it to the device
        self._adopt(state_from_numpy(new))

    def global_state(self) -> dict:
        """The whole state as host numpy arrays in the reference's layout
        and dtypes (`convert.state_to_numpy`)."""
        from repro_torch.engine.convert import state_to_numpy

        return state_to_numpy(self._st)

    # -- the cycle -----------------------------------------------------------

    def _lanes_of(self, active: np.ndarray):
        """(lane mask (B L,) bool, trial increments (B,) int32) on the
        device for the host mask `active`, kept while it stays the same."""
        key = active.tobytes()
        if self._frozen[0] != key:
            a = torch.from_numpy(active).to(self.device)
            self._frozen = (key, (a.repeat_interleave(self.lanes),
                                  a.to(I32)))
        return self._frozen[1]

    def _cycle_perm(self) -> torch.Tensor:
        """Each trial's delay permutation for this cycle, (B, 10): row
        ``(t + 1) * 0x9E3779B1 + salt`` >> 28 of its `perms`."""
        st = self._st
        if self.batch == 1:
            h = (((self._t + 1) & M32) * 0x9E3779B1 + self._salt) & M32
            return st.perms[h >> 28][None]
        h = (_mul32((st.t.long() + 1) & M32, 0x9E3779B1) + st.salt_enq) & M32
        return st.perms[torch.arange(self.batch, device=self.device), h >> 28]

    def _cycle(self, active: Optional[np.ndarray] = None) -> None:
        """One simulation cycle, in place: drain each lane's due bucket,
        route, accept, react; stage every re-entering or new row with its
        lane-relative delay ordinal; append to the owner lanes. Disarmed,
        no host sync; armed, one host read of the due slot's largest lane
        count of alerts, which sizes the window.

        On a trial axis, `active` ((B,) bool on the host, None: all)
        selects the trials that step; the others are frozen bit for bit."""
        st, pl, dev, f = self._st, self._plane, self.device, self._faults
        pd, d, L, pw = self.rows, self.d, self.loc_lanes, self.pw
        Bl, Al = self.lane_budget, self.lane_alert_w
        Wl, cap, roww = self.lane_width, self.lane_cap, self.roww
        B, lane_ar = self.batch, self._lane_ar
        if active is not None and active.all():
            active = None
        act_l = None if active is None else self._lanes_of(active)[0]
        t_on = self._tb if active is None else self._tb[active]
        if (t_on == t_on[0]).all():
            # the stepping trials share t (a frozen trial's lanes read the
            # same slot, masked, and write back what they read)
            t = int(t_on[0])
            s, s1 = t % SLOTS, (t + 1) % SLOTS
            at = lambda slot: (slice(None), slot)
        else:
            # per-trial t: each lane reads and writes its own trial's slot
            t = st.t.long()[:, None].expand(B, self.lanes).reshape(L, 1)
            s, s1 = t[:, 0] % SLOTS, (t[:, 0] + 1) % SLOTS
            at = lambda slot: (lane_ar, slot)
        # the due slot's rows (a view, or each lane's own slot gathered);
        # every read of `sbuf` happens before the slot is rewritten below
        sbuf = st.wheel[at(s)]
        acnt_s = st.acnt[at(s)].clone()
        wcnt_s = st.wcnt[at(s)].clone()
        n_alert, dcnt = acnt_s, wcnt_s
        if act_l is not None:  # a frozen trial's window is empty
            n_alert = torch.where(act_l, acnt_s, 0)
            dcnt = torch.where(act_l, wcnt_s, 0)
        n_data = torch.clamp(dcnt, max=Bl)

        # lane-major window: per lane [Aw alert rows, B_l data rows]. An
        # armed side-wheel is sized for the worst probe burst (3 pad + 16
        # rows a lane-slot, 6.3 M at n = 1e6); its window takes only the
        # due slot's largest lane count of alerts (a host read). Only rows
        # past every lane's live alerts go, so no row changes its order
        # and the bits are the full window's; the fault draws key on the
        # full window's index (`wfull` below)
        Aw = Al if f is None else pl.all_max(n_alert)
        WWl = Aw + Bl
        WW = L * WWl
        w = torch.cat([st.awheel[at(s) + (slice(None, Aw),)], sbuf[:, :Bl]],
                      dim=1).reshape(WW, roww)
        li = torch.arange(WWl, device=dev)
        is_alert_l = li < Aw
        live = torch.where(is_alert_l[None, :], li[None, :] < n_alert[:, None],
                           (li - Aw)[None, :] < n_data[:, None]).reshape(WW)
        is_alert = is_alert_l.expand(L, WWl).reshape(WW)
        has_alerts = n_alert.sum() > 0
        w_origin, w_dest, w_edge = w[:, ORIGIN], w[:, DEST], w[:, EDGE]
        w_has_edge = ((w[:, HAS_EDGE] & 1) != 0) & live
        w_cont = (w[:, HAS_EDGE] & CONT) != 0
        w_pay = w[:, PAY0:PAY0 + pw]
        w_seq = _i32(w[:, self._SEQ])
        if f is not None:
            # probe rows ride the alert side-wheel but are not alerts: they
            # route like data; an accept refreshes `heard` and forces Send
            w_probe = (w[:, HAS_EDGE] & PROBE) != 0
            is_alert = is_alert & ~w_probe

        owner = self._owner_of(w_dest)
        pos_i, a_prev, a_self = st.pos[owner], st.prev[owner], st.addrs[owner]
        self_seg = in_segment(w_origin, a_prev, a_self)
        # the R2 repair's ring maximum, one per trial (and per window row)
        max_addr = st.addrs.view(B, self.pad)[:, self.n - 1].contiguous()
        max_row = (max_addr if B == 1 else
                   max_addr[:, None].expand(B, WW // B).reshape(WW))

        # ---- the injected faults at the due-scan: rows whose owner has
        # crashed are lost (any kind); live data rows are dropped or
        # re-delayed by seeded hashes of their window index (probes and
        # ALERTs ride the reliable plane). Lost and delayed rows leave
        # `live` before routing and are not charged this cycle
        if f is not None:
            lost_m = live & st.dead[owner]
            is_data_row = ~is_alert & ~w_probe
            # (the global lane index, so every world size draws alike)
            wfull = ((torch.arange(L, device=dev)[:, None] + pl.lane_base)
                     * self.window_l
                     + torch.where(is_alert_l, li, li - Aw + Al)).reshape(WW)
            if f.p_drop > 0.0:
                lost_m = lost_m | (live & is_data_row & (
                    hash_u32(wfull, t, self._fsalt_drop) < self._p_drop_thr))
            delay_m = torch.zeros_like(live)
            if f.p_delay > 0.0:
                delay_m = live & is_data_row & ~lost_m & (
                    hash_u32(wfull, t, self._fsalt_delay) < self._p_delay_thr)
            live = live & ~lost_m & ~delay_m
            n_lost_l = lost_m.reshape(L, WWl).sum(1, dtype=I32)

        # ---- Alg. 1 delivery: two full-width descent steps, then the
        # narrow tail for the few rows still descending
        entry = live & ~w_cont
        lv, cur_d, cur_e, cur_h = live, w_dest, w_edge, w_has_edge
        acc = torch.zeros(WW, dtype=torch.bool, device=dev)
        drop = torch.zeros_like(acc)
        o_dest, o_edge, o_he = w_dest, w_edge, w_has_edge
        for _ in range(2):
            dlv = P.deliver_rules(
                origin=w_origin, dest=cur_d, edge=cur_e, has_edge=cur_h,
                network_entry=entry, pos_i=pos_i, a_prev=a_prev,
                a_self=a_self, self_seg=self_seg, max_addr=max_row, d=d)
            moving = lv & ~dlv.accept & ~dlv.drop
            stay = moving & in_segment(dlv.new_dest, a_prev, a_self)
            fwdn = moving & ~stay
            acc = acc | (lv & dlv.accept)
            drop = drop | (lv & dlv.drop & ~dlv.accept)
            o_dest = torch.where(fwdn, dlv.new_dest, o_dest)
            o_edge = torch.where(fwdn, dlv.new_edge, o_edge)
            o_he = torch.where(fwdn, dlv.new_has_edge, o_he)
            cur_d = torch.where(stay, dlv.new_dest, cur_d)
            cur_e = torch.where(stay, dlv.new_edge, cur_e)
            cur_h = torch.where(stay, dlv.new_has_edge, cur_h)
            entry = entry & ~stay
            lv = stay
        # narrow tail: compact the survivors per lane (alerts come first
        # in each lane and narrow_l >= lane_alert_w, so only data spills)
        # a narrow width past the window cannot spill: the same rows stay
        NWl = min(self.narrow_l, WWl)
        NT = L * NWl
        lv_l = lv.reshape(L, WWl)
        sidx_l, scum_l = self._compact(lv_l, NWl)
        spill = (lv_l & (scum_l > NWl)).reshape(WW)
        sok_l = sidx_l < WWl
        sp = torch.where(sok_l, sidx_l + (torch.arange(L, device=dev) * WWl)[:, None],
                         0).reshape(NT)
        sok = sok_l.reshape(NT)
        acc2, drop2, od2, oe2, ohe2 = self._descent(
            w_origin[sp], cur_d[sp], cur_e[sp], cur_h[sp], sok,
            torch.zeros(NT, dtype=torch.bool, device=dev), pos_i[sp],
            a_prev[sp], a_self[sp], self_seg[sp], max_addr, d)
        pack = torch.stack([acc2.long() | (drop2.long() << 1), od2, oe2,
                            ohe2.long()], dim=1)
        stage = torch.zeros((WW + 1, 4), dtype=I64, device=dev)
        stage.index_put_((torch.where(sok, sp, WW),), pack)
        stage = stage[:WW]
        merged = lv & ~spill
        acc = acc | (merged & ((stage[:, 0] & 1) != 0))
        drop = drop | (merged & ((stage[:, 0] & 2) != 0))
        o_dest = torch.where(merged, stage[:, 1], o_dest)
        o_edge = torch.where(merged, stage[:, 2], o_edge)
        o_he = torch.where(merged, stage[:, 3] != 0, o_he)
        fwd = live & ~acc & ~drop & ~spill

        # ---- ACCEPT: one data winner per (peer, dir) link per cycle;
        # losers re-enter the wheel. An accepted ALERT zeroes the link and
        # forces Send(v).
        recv = owner
        flat = recv * NDIR + A.direction_of(w_origin, st.pos[recv], d)
        acc_d = acc & ~is_alert
        acc_a = acc & is_alert
        sent = pd * NDIR  # scatter sentinel
        link_seq = pl.take_link(st.inbox, flat)[:, pw].contiguous()
        # the election runs on the plane's own link ids (local on a rank)
        lflat, nl = pl.link_ids(flat)
        if f is None:
            winner, loser, fresh, alert_write, is_rep, aforce = self._dedup(
                lflat, acc_d, acc_a, w_seq, link_seq, nl)
        else:
            acc_p = acc & w_probe
            acc_d = acc_d & ~w_probe
            # every accept (data, duplicate, alert or probe) is proof of
            # life on its link; t is monotone, so max == set
            pl.put_link("heard", torch.where(acc, flat, sent), st.t)
            (winner, loser, fresh, alert_write, is_rep, aforce,
             pforce) = due_dedup_reference(lflat, acc_d, acc_a, w_seq,
                                           link_seq, nl, acc_p=acc_p)
        # one scatter: a fresh data write, or an alert zeroing a link with
        # no data winner (alert rows on one link all write zeros)
        data_idx = torch.where(fresh | alert_write, flat, sent)
        data_val = torch.where(
            alert_write[:, None], 0,
            torch.cat([_i32(w_pay), w_seq[:, None]], dim=1))
        pl.put_link("inbox", data_idx, data_val)

        # ---- react: test() + Send on the touched peers, one
        # representative window row per peer; the send block is scattered
        # back to window-row positions (the staging ordinals are
        # lane-relative)
        reps_w, _ = self._compact(is_rep, WW)
        rvalid = reps_w < WW
        reps_safe = torch.where(rvalid, reps_w, 0)
        rp = torch.where(rvalid, recv[reps_safe], 0)
        link = rp[:, None] * NDIR + torch.arange(NDIR, device=dev)[None, :]
        rin = pl.take_link(st.inbox, link)        # (WW, 3, P+1)
        ro = pl.take_peer(st.out, rp)             # (WW, 3P+1)
        viol, _, pay = self._rules(rin[..., :pw], self._out_pay(ro),
                                   pl.take_peer(st.x, rp))
        force = aforce[reps_safe] & has_alerts
        if f is not None:
            # the probe ack: an unconditional Send back on the probed link
            force = force | pforce[reps_safe]
        eff = (viol | force) & rvalid[:, None]
        seq2 = ro[:, NDIR * pw] + eff.any(1).to(I32)
        ro2 = self._pack_out(torch.where(eff[..., None], pay, self._out_pay(ro)),
                             seq2)
        pl.put_peer("out", torch.where(rvalid, rp, pd), ro2)

        dirs3 = torch.arange(NDIR, device=dev).expand(WW, NDIR)
        bc = lambda a: a[:, None].expand(WW, NDIR)
        valid, s_origin, s_dest, s_edge, s_he = P.send_fields(
            bc(st.pos[rp]), dirs3, bc(st.addrs[rp]), bc(st.prev[rp]), d)
        widx = torch.where(rvalid, reps_safe, WW)

        def back(v):
            o = torch.zeros((WW + 1,) + v.shape[1:], dtype=v.dtype, device=dev)
            o.index_put_((widx,), v)
            return o[:WW]

        cand = back(eff & valid)          # (WW, NDIR) bool, window order
        b_origin, b_dest = back(s_origin), back(s_dest)
        b_edge, b_he = back(s_edge), back(s_he.long())
        b_pay = back(pay)                 # (WW, NDIR, P)
        b_seq = back(seq2)                # (WW,)

        # ---- wheel maintenance: slip one cycle, shift leftovers to the
        # front (revisited a revolution later), count each backlog row
        # once (LATE bit). A frozen lane's slot and counts are written
        # back as they were, and its slip rows go to the sentinel row
        wcnt_s1 = st.wcnt[at(s1)].clone()
        slip_avail = torch.clamp(dcnt - Bl, 0, Bl)
        slip_k = torch.minimum(slip_avail, cap - wcnt_s1)
        leftover = torch.clamp(dcnt - Bl - slip_k, 0, Wl - 2 * Bl)
        tail = sbuf[:, Bl:]
        tail_live = (torch.arange(Wl - Bl, device=dev)[None, :]
                     < (dcnt - Bl)[:, None])
        n_late_new = (tail_live & ((tail[:, :, HAS_EDGE] & LATE) == 0)).sum(
            1, dtype=I32)
        sh = (Bl + slip_k.long())[:, None] + torch.arange(Wl - 2 * Bl, device=dev)
        shifted = torch.gather(sbuf, 1, sh[:, :, None].expand(L, Wl - 2 * Bl, roww))
        shifted[:, :, HAS_EDGE] |= LATE
        slip_rows = sbuf[:, Bl:2 * Bl].clone()
        slip_rows[:, :, self._DT] = (t + 1) & M32
        slip_rows[:, :, HAS_EDGE] |= LATE
        si = wcnt_s1.long()[:, None] + torch.arange(Bl, device=dev)
        if act_l is not None:
            shifted = torch.where(act_l[:, None, None], shifted,
                                  sbuf[:, :Wl - 2 * Bl])
            leftover = torch.where(act_l, leftover, wcnt_s)
        st.wheel[at(s) + (slice(None, Wl - 2 * Bl),)] = shifted  # sbuf stale
        st.wcnt[at(s)] = leftover
        st.acnt[at(s)] = 0 if act_l is None else torch.where(act_l, 0, acnt_s)
        if act_l is None and isinstance(s1, int):
            st.wheel[:, s1].scatter_(1, si[:, :, None].expand(L, Bl, roww),
                                     slip_rows)
        else:
            # rows of the wheel's storage in each lane's own slot; a
            # frozen lane's go to the sentinel row past the wheel
            si = si + ((lane_ar * SLOTS + s1) * Wl)[:, None]
            if act_l is not None:
                si = torch.where(act_l[:, None], si, L * SLOTS * Wl)
            self._store["wheel"].index_put_((si.reshape(-1),),
                                            slip_rows.reshape(-1, roww))
        st.wcnt[at(s1)] = wcnt_s1 + slip_k

        # ---- staging: one rigid per-lane block [WWl re-entry rows |
        # 3*WWl send rows]; the delay ordinal is the row's rank within its
        # lane's block, and `stage_rows` stamps DELIVER_T
        f_dest = torch.where(fwd, o_dest, torch.where(spill, cur_d, w_dest))
        f_edge = torch.where(fwd, o_edge, torch.where(spill, cur_e, w_edge))
        f_he = (torch.where(fwd, o_he, torch.where(spill, cur_h, w_has_edge)).long()
                | torch.where(spill | loser, CONT, 0))
        re_mask = fwd | loser | spill
        re_alert = fwd & is_alert
        if f is not None:
            # forwarded probes keep their bit; a delayed row re-enters as a
            # fresh delivery, except that a delayed mid-descent row keeps
            # CONT (its network entry was already charged)
            f_he = (f_he | torch.where(w_probe, PROBE, 0)
                    | torch.where(delay_m & w_cont, CONT, 0))
            re_mask = re_mask | delay_m
            re_alert = fwd & (is_alert | w_probe)
        re_rows = torch.stack(
            [w_origin, f_dest, f_edge, f_he]
            + [w_pay[:, c] for c in range(pw)]
            + [w[:, self._SEQ], w[:, self._DT]], dim=1).reshape(L, WWl, roww)
        u = lambda a: _u32(a.reshape(-1))
        send_pay = b_pay.reshape(-1, pw)
        send_rows = torch.stack(
            [u(b_origin), u(b_dest), u(b_edge), u(b_he)]
            + [_u32(send_pay[:, c]) for c in range(pw)]
            + [u(bc(b_seq)), u(bc(b_seq))], dim=1).reshape(L, NDIR * WWl, roww)
        blk_rows = torch.cat([re_rows, send_rows], dim=1)
        blk_mask = torch.cat([re_mask.reshape(L, WWl),
                              cand.reshape(L, NDIR * WWl)], dim=1)
        blk_alert = torch.cat(
            [re_alert.reshape(L, WWl),
             torch.zeros((L, NDIR * WWl), dtype=torch.bool, device=dev)],
            dim=1)
        ordinal = torch.cumsum(blk_mask.to(I32), dim=1, dtype=I64) - 1
        staged = self._stage(blk_rows.reshape(-1, roww), blk_alert.reshape(-1),
                             ordinal.reshape(-1), self._cycle_perm(),
                             st.t.reshape(-1), self._DT)

        # ---- boundary exchange + ranked owner-lane appends: the one step
        # of the cycle that crosses lanes. The staged blocks (and an armed
        # engine's probe block) become the global lane-major order on
        # every rank (the identity on one device), so the ranks within
        # each (lane, slot) group are the same at every world size
        blocks = [(staged.view(L, 4 * WWl, roww), blk_mask, blk_alert)]
        if f is not None:
            blocks.append(self._probes())
        blocks = pl.exchange(*blocks)
        grows, glive, galert = blocks[0]
        Lg = grows.shape[0]  # lanes of every rank
        grows = grows.reshape(-1, roww)
        glive, galert = glive.reshape(-1), galert.reshape(-1)
        glane = self._lane_of(grows[:, DEST])
        gslot = _i32(grows[:, self._DT]).long() % SLOTS
        att_d, dro_d = self._append_rows("wheel", st.wcnt, grows, glane, gslot,
                                         glive & ~galert, cap)
        # ALERT appends: only the first Aw re-entry rows of each lane's
        # block can be alerts (the probe block of an armed engine follows
        # each lane's block), so ranking those sub-blocks in the same
        # relative order gives the reference's bits; with no alert live
        # it writes only the sentinel row — the reference's lax.cond no-op
        ab = [a.reshape(Lg, 4 * WWl, *a.shape[1:])[:, :Aw]
              for a in (grows, glane, gslot, glive & galert)]
        if f is not None:
            prows, plive, _ = blocks[1]
            p_lane = self._lane_of(prows[:, :, DEST].reshape(-1))
            p_lane = p_lane.reshape(Lg, -1)
            pb = (prows, p_lane,
                  torch.full_like(p_lane, (self._t + 1) % SLOTS), plive)
            ab = [torch.cat([a, b], dim=1) for a, b in zip(ab, pb)]
        att_a, dro_a = self._append_rows(
            "awheel", st.acnt, *[a.reshape(-1, *a.shape[2:]) for a in ab], Al)

        # ---- accounting (per lane): every first-entry live window row is
        # one consumed network delivery; continuations were already charged
        n_defer_l = (loser | spill).reshape(L, WWl).sum(1, dtype=I32)
        if f is None:
            n_cont_l = (live & w_cont).reshape(L, WWl).sum(1, dtype=I32)
            st.messages_sent.add_(n_alert + n_data - n_cont_l)
            st.ret.add_(n_alert + n_data)
        else:
            # only rows routed this cycle and not yet charged (CONT) consume
            # a delivery; lost rows retire into the fault ledger
            st.messages_sent.add_((live & ~w_cont).reshape(L, WWl).sum(
                1, dtype=I32))
            st.ret.add_(n_alert + n_data - n_lost_l)
            st.lost.add_(n_lost_l)
        st.deferred.add_(n_late_new + n_defer_l)
        st.dropped.add_(dro_d + dro_a)
        st.enq.add_(att_d + att_a)
        if active is None:
            st.t.add_(1)
            self._tb += 1
        else:
            st.t.add_(self._lanes_of(active)[1])
            self._tb += active

    def _probes(self):
        """The failure detector's probe emission of this cycle: every link
        of a live peer that is structurally valid and silent past
        `suspect_after` (and not probed within that window) emits an
        empty-payload PROBE row, due next cycle on the side-wheel. Stamps
        `probed`; returns the plane's (L, lane_rows * 3) lane-major block
        as an exchange block (rows, live, None)."""
        st, f, t, dev = self._st, self._faults, self._t, self.device
        pd, L, pl = self.loc_rows, self.loc_lanes, self._plane
        bc = lambda a: pl.local(a)[:, None].expand(pd, NDIR)
        valid, org, dst, edge, he = P.send_fields(
            bc(st.pos), torch.arange(NDIR, device=dev).expand(pd, NDIR),
            bc(st.addrs), bc(st.prev), self.d)
        mon = valid & ~bc(st.dead) & pl.occ()[:, None]
        want, _ = P.suspicion_rules(st.heard, st.probed, t, f.suspect_after,
                                    f.evict_after)
        emit = want.reshape(pd, NDIR) & mon
        st.probed.masked_fill_(emit.reshape(-1), t)
        zero = torch.zeros_like(org)
        rows = torch.stack([org, dst, edge, he.long() | PROBE]
                           + [zero] * self.pw
                           + [zero, torch.full_like(org, (t + 1) & M32)],
                           dim=2).reshape(L, -1, self.roww)
        return rows, emit.reshape(L, -1), None

    # -- public API ----------------------------------------------------------

    def _one_trial(self, what: str) -> None:
        """The public entry points read and write one trial (the host
        mirrors hold trial 0's time and salt); on a trial axis they raise
        rather than compute a wrong state."""
        if self.batch > 1:
            raise NotImplementedError(
                f"TorchEngine.{what} takes one trial; drive a trial axis "
                f"through engine.batched.BatchedTorchEngine")

    @property
    def t(self) -> int:
        self._one_trial("t")
        return self._t

    @property
    def messages_sent(self) -> int:
        return self._plane.total(self._st.messages_sent)

    @property
    def in_flight(self) -> int:
        return (self._plane.total(self._st.wcnt)
                + self._plane.total(self._st.acnt))

    @property
    def dropped(self) -> int:
        """Messages lost to arena overflow; a run with dropped > 0 is
        invalid (raise capacity_per_peer)."""
        return self._plane.total(self._st.dropped)

    @property
    def deferred(self) -> int:
        """Deliveries pushed past their due time (each row counted once)."""
        return self._plane.total(self._st.deferred)

    @property
    def lost_to_fault(self) -> int:
        """Messages destroyed by the injected fault plane (crashed owners
        and `FaultConfig.p_drop`), itemized apart from `dropped`."""
        return self._plane.total(self._st.lost)

    @property
    def evictions(self):
        """[(cycle, address), ...] leaves the failure detector synthesized."""
        return list(self._evictions)

    def dead_mask(self) -> np.ndarray:
        """(n,) bool: crashed peers the detector has not yet evicted."""
        return self._st.dead[: self.n].cpu().numpy().copy()

    def last_heard(self) -> np.ndarray:
        """(n,) cycle each peer's links last carried inbound traffic."""
        heard = self._plane.full(self._st.heard)
        return heard.reshape(-1, NDIR)[: self.n].amax(1).cpu().numpy()

    @property
    def deferral_rate(self) -> float:
        """Cumulative deferral events per consumed network delivery."""
        m = self.messages_sent
        return self.deferred / m if m else 0.0

    def check_conservation(self) -> dict:
        """The wheel's row-conservation invariant: every row ever appended
        is drained, still live, or accounted dropped. Raises
        AssertionError on violation; returns the figures."""
        self._one_trial("check_conservation")
        st, total = self._st, self._plane.total
        enq, ret = total(st.enq), total(st.ret)
        live = self.in_flight
        dro, lost = total(st.dropped), total(st.lost)
        if enq != ret + live + dro + lost:
            raise AssertionError(
                f"wheel conservation violated: enqueued={enq} != "
                f"retired={ret} + live={live} + dropped={dro} + "
                f"lost_to_fault={lost}")
        return {"enqueued": enq, "retired": ret, "live": live,
                "dropped": dro, "lost_to_fault": lost}

    def outputs(self) -> np.ndarray:
        self._one_trial("outputs")
        out = knowledge_outputs(self.problem, self._st.inbox, self._st.x,
                                self.loc_rows)
        out = self._plane.full(out)
        return out[: self.n].cpu().numpy().astype(np.int64)

    def votes(self) -> np.ndarray:
        """(n,) scalar data (majority votes); (n, D) when D > 1."""
        self._one_trial("votes")
        x = self.data()
        return x[:, 0] if self.dw == 1 else x

    def data(self) -> np.ndarray:
        """(n, D) quantized per-peer data plane."""
        self._one_trial("data")
        x = self._plane.full(self._st.x)
        return x[: self.n].cpu().numpy().astype(np.int64)

    def set_votes(self, idx: np.ndarray, new_votes: np.ndarray) -> None:
        """Data-change upcall: set X_self on `idx` and re-run test()."""
        self._one_trial("set_votes")
        idx_t = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        nd = self.problem.init_state(np.asarray(new_votes)).astype(np.int32)
        self._plane.put_peer("x", idx_t, torch.from_numpy(nd))
        touched = torch.zeros(self.pad, dtype=torch.bool, device=self.device)
        touched[idx_t] = True
        self._react(self._plane.local(touched))

    def apply_coalesced(self, idx: np.ndarray, new_data: np.ndarray) -> int:
        """Serve-layer flush: one coalesced batch applied as one batched
        `set_votes` (one full-width event react). Returns the rows applied."""
        idx, vals = coalesced_update(idx, new_data, self.n)
        if idx.size:
            self.set_votes(idx, vals)
        return int(idx.size)

    def join(self, addr: int, vote=0) -> int:
        """Membership upcall: a peer joins at `addr` (Alg. 2) with scalar
        data or a (D,) vector in raw units; returns its row. Outgrowing
        the padded tables re-pads them first (`_grow`)."""
        self._one_trial("join")
        ring_after, k = self.ring.join(int(addr))
        if ring_after.n > self.pad:
            self._grow(ring_after.n)
        self._join(int(addr), self.problem.peer_data(vote), k)
        self.ring = ring_after
        if self._faults is not None:
            self._stamp_churn_floor(N.join_event(ring_after, k), ring_after)
        return k

    def leave(self, idx: int) -> None:
        """Membership upcall: peer `idx` departs (Alg. 2)."""
        self._one_trial("leave")
        if self.n <= 1:
            raise ValueError("cannot leave the last peer")
        if not 0 <= idx < self.n:
            raise IndexError(f"peer index {idx} out of range [0, {self.n})")
        ring_before = self.ring
        self._leave(int(idx))
        self.ring = ring_before.leave(idx)
        if self._faults is not None:
            self._stamp_churn_floor(
                N.leave_event(self.ring, ring_before, idx), self.ring)

    def crash(self, idx: int) -> None:
        """Abrupt-failure upcall: peer `idx` vanishes silently — its rows
        zero and it never sends again, with no Alg. 2 notification; its
        tree neighbours find it through the timeout detector. Rows in
        flight toward it die at the due-scan (`lost_to_fault`). Requires
        an armed fault plane (``faults=`` at construction)."""
        self._one_trial("crash")
        if self._faults is None:
            raise RuntimeError(
                "crash() requires an armed fault plane (faults=FaultConfig)")
        if self.n <= 1:
            raise ValueError("cannot crash the last peer")
        if not 0 <= idx < self.n:
            raise IndexError(f"peer index {idx} out of range [0, {self.n})")
        st = self._st
        if bool(st.dead[idx]):
            raise ValueError(f"peer {idx} is already dead")
        pl, dev = self._plane, self.device
        it = torch.tensor([idx], device=dev)
        st.dead[idx] = True
        pl.put_peer("x", it, 0)
        pl.put_link("inbox", idx * NDIR + torch.arange(NDIR, device=dev), 0)
        pl.put_peer("out", it, 0)

    def _stamp_churn_floor(self, ev, ring_after) -> None:
        """Record the synchronous `heard` refresh the reference simulator
        performs at a churn event — the movers (owners of the two change
        positions) on every direction, the routed ALERT recipients on the
        alerted one — keyed by (address, dir) so it survives row shifts.
        Until the routed alerts accept, the floor keeps `_fault_sweep`
        from reading the re-healed links as silent."""
        pos = ring_after.positions()
        dt = ring_after.addrs.dtype
        for p in (ev.pos_fix, ev.pos_var):
            o = int(ring_after.owner(np.asarray([p], dt))[0])
            if int(pos[o]) == int(p):
                for dch in range(NDIR):
                    self._heard_floor[(int(ring_after.addrs[o]), dch)] = self._t
        for peer, dch in ev.notifs:
            self._heard_floor[(int(ring_after.addrs[peer]), int(dch))] = self._t

    def _fault_sweep(self) -> None:
        """The failure detector's eviction pass, on the host, at dispatch
        boundaries (after each `step` call and each convergence chunk):
        read the stamps, elect the first-dark-hop accused peer
        (`core.majority.elect_eviction`) and synthesize its Alg. 2 leave,
        lowest address first, one per iteration, re-reading the shifted
        stamps until none is convicted."""
        f = self._faults
        if f is None or not f.evict_after:
            return
        t = self._t
        while self.n > 1:
            st = self._st
            pl = self._plane
            heard = np.maximum(
                pl.full(st.heard).reshape(-1, NDIR)[: self.n].cpu().numpy(),
                self._evict_floor)
            if self._heard_floor:
                row_of = {int(a): i for i, a in enumerate(self.ring.addrs)}
                for (a, dch), ts in self._heard_floor.items():
                    r = row_of.get(a)
                    if r is not None and heard[r, dch] < ts:
                        heard[r, dch] = ts
            probed = pl.full(st.probed).reshape(-1, NDIR)[: self.n]
            probed = probed.cpu().numpy()
            dead = st.dead[: self.n].cpu().numpy()
            _, evict = P.suspicion_rules(heard.ravel(), probed.ravel(), t,
                                         f.suspect_after, f.evict_after)
            pos = np.asarray(self.ring.positions())
            peers, dirs, mon = monitored_links(self.ring, pos, dead)
            if not (evict & mon).any():
                return
            target = elect_eviction(self.ring, pos, peers, dirs, mon, evict,
                                    heard.ravel(),
                                    eviction_grace(self.n, f.suspect_after))
            if target < 0:
                return
            self._evictions.append((t, int(self.ring.addrs[target])))
            self.leave(target)  # Alg. 2 verbatim: eviction IS a leave
            self._evict_floor = t - f.evict_after + eviction_grace(
                self.n, f.suspect_after)

    def step(self, cycles: int = 1) -> None:
        """Advance `cycles` cycles (disarmed, no host sync inside; armed,
        one host read a cycle to size its window); an armed engine then
        runs its eviction sweep (eviction timing follows the step
        granularity, as the reference's)."""
        self._one_trial("step")
        for _ in range(int(cycles)):
            self._cycle()
        self._fault_sweep()

    def run_until_converged(self, truth: int, max_cycles: int = 200_000,
                            stable_for: int = 1) -> EngineResult:
        """Run until every peer outputs `truth`, checked on device before
        each step (one host read of the check per cycle), in chunks of at
        most `CHUNK` checks; an armed engine runs its eviction sweep
        after each chunk, at the reference's dispatch boundaries."""
        self._one_trial("run_until_converged")
        start_msgs = self.messages_sent
        state = {"stable": 0}

        def probe(budget: int):
            stable, done, used = state["stable"], False, 0
            while not done and used < min(budget, CHUNK):
                conv = bool(self._outputs_match(truth))
                stable = stable + 1 if conv else 0
                done = stable >= stable_for
                if not done:
                    self._cycle()
                used += 1
            state["stable"] = stable
            self._fault_sweep()
            return done, used

        return run_convergence_loop(
            probe, max_cycles,
            cycles=lambda: self.t,
            messages=lambda: self.messages_sent - start_msgs,
            invalid=lambda: float(self.dropped > 0),
        )
