"""Per-device work counts of an eager step: dot FLOPs, an HBM byte model
and collective bytes by kind. The port's counterpart of
`repro.analysis.hlo`, which reads them from the compiled HLO; eager
PyTorch has no HLO, so they are counted as the ops dispatch.

  * flops: FlopCounterMode's formulas (``torch.utils.flop_counter``'s
    registry: 2 * prod(out) * prod(contract) for every matmul, the
    reference's "2 prod(out) prod(contract) for every dot"), applied to
    every op that reaches a plain tensor;
  * bytes: every such op's input and output bytes, views and empty
    allocations skipped. Each eager op is one round trip through memory,
    so this is the unfused model that the reference's ``bytes`` stands
    for (it skips only the interiors of XLA's fusions);
  * collectives: the output bytes of every functional collective
    (`torch.ops._c10d_functional`: all-gather, all-reduce,
    reduce-scatter, all-to-all), keyed by the reference's kind names
    (`COLLECTIVES`).

Under DTensor the counts are per device: a DTensor op first dispatches
here with its global shapes, which `Counter` declines (DTensor then
runs it), and DTensor's own shape inference on fake tensors is skipped;
what is counted is the op on this rank's local shards, and the
collectives DTensor issues between them. On the meta device nothing is
computed, so a step of any size counts in seconds.

The reference scales the ops inside ``while`` bodies by their trip
counts (`loop_scales`, `op_flops_by_loop`), since XLA's cost analysis
counts a scanned body once; an eager run dispatches every op each time
it runs, so there is nothing to scale.

Memory: the peak of the bytes live in the storages that the counted
ops (and collectives) allocated, each tracked from its first output
until its storage is freed (autograd's saved tensors keep theirs
alive): the step's temporaries, beside the arguments it was given. A
storage that only a reference cycle holds is freed when Python's cycle
collector runs, whose timing depends on everything the process did
before; so a `Counter` collects on entry, turns the automatic collector
off while it is open, and collects every `GC_EVERY` ops itself: the
peak of a step is the same whatever ran before it.

The port's hand-written kernels that are operators of torch's
dispatcher (namespace ``repro_torch``: the flash attention's forward,
`kernels.flash_attention.flash_fwd_op`) count as one op each: their
dot FLOPs from `KERNEL_FLOPS`, their bytes as their inputs read and
outputs written once, both also summed apart as the reference's
``kernel_scope_*`` (what a fused kernel keeps on chip is not moved).
On the meta device such an op makes only its outputs' shapes, so a
32k-token attention counts at once.
"""
from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention.xla_ref import (blocking,
                                                         visible_pairs)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no bytes: metadata, allocation, waits
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "lift_fresh", "detach", "alias",
         "wait_tensor", "_wrap_tensor_autograd", "_to_copy_meta"}

KERNELS = "repro_torch"  # the namespace of the port's kernel operators
GC_EVERY = 10_000  # ops between a Counter's own cycle collections


def _flash_flops(q, k, v, causal=True, window=None, scale=None,
                 q_offset=0) -> float:
    """The flash kernel's products: QK^T and PV over the (q block, kv
    block) pairs its schedule visits (`xla_ref.visible_pairs`)."""
    b, hq, sq, dqk = q.shape
    skv, dv = k.shape[2], v.shape[3]
    c, sqp, skp = blocking(sq, skv)
    pairs = len(visible_pairs(sqp // c, skp // c, c, causal, window,
                              q_offset))
    return 2.0 * b * hq * pairs * c * c * (dqk + dv)


# dot FLOPs of each kernel operator, a function of its arguments
KERNEL_FLOPS = {"flash_attention_fwd": _flash_flops}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _fake_mode() -> bool:
    """Inside a fake tensor mode (DTensor's shape inference, whose
    allocations are no rank's)."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class Counter(TorchDispatchMode):
    """The dispatch mode that counts; its totals are `totals()`. With a
    `deadline` (a `time.monotonic()` value) an op dispatched past it
    raises TimeoutError, naming the op."""

    def __init__(self, deadline: Optional[float] = None):
        super().__init__()
        self.deadline = deadline
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._held = set()  # ids of the storages tracked
        self._ops = 0
        self._gc = False  # whether the automatic collector was on

    def _track(self, out, args) -> None:
        """Tracks the storages of `out` that are new (not an input's)."""
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor) or any(t is a for a in args):
                continue
            st = t.untyped_storage()
            if id(st) in self._held:
                continue
            n = st.nbytes()
            self._held.add(id(st))
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, id(st), n)

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise TimeoutError(f"past the time limit at {func}")
        self._ops += 1
        if self._ops % GC_EVERY == 0:
            gc.collect()
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        if types or _fake_mode():
            return out  # a subclass's op: DTensor's shape inference
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" or ns == "c10d":
            kind = _KINDS.get(name)
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0.0)
                                          + _nbytes(out))
                self._track(out, args)
            return out
        flops = 0.0
        packet = func._overloadpacket
        if ns == KERNELS:
            flops = float(KERNEL_FLOPS[name](*args, **kwargs))
        elif packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        moved = 0.0
        if not (func.is_view or name in _FREE):
            moved = float(_nbytes(list(args) + list(kwargs.values()))
                          + _nbytes(out))
        self.flops += flops
        self.bytes += moved
        if not func.is_view and not name.endswith("_"):
            self._track(out, args)
        if ns == KERNELS:
            self.kernel_flops += flops
            self.kernel_bytes += moved
        return out

    def __enter__(self):
        self._gc = gc.isenabled()
        gc.collect()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        if self._gc:
            gc.enable()
        return super().__exit__(*exc)

    def totals(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernel_scope_flops": self.kernel_flops,
                "kernel_scope_bytes": self.kernel_bytes,
                "peak_bytes": self.peak,
                "collectives": {k: self.collectives.get(k, 0.0)
                                for k in COLLECTIVES
                                if k in self.collectives}}


def flops_and_bytes(fn, *args, deadline: Optional[float] = None,
                    **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """(fn(*args, **kwargs), its per-device counts: "flops", "bytes",
    "kernel_scope_flops", "kernel_scope_bytes", "peak_bytes" and
    "collectives", the bytes by kind); `deadline` as `Counter`'s."""
    with Counter(deadline) as c:
        out = fn(*args, **kwargs)
    return out, c.totals()


@contextlib.contextmanager
def collective_bytes():
    """Yields a dict that, when the block ends, holds the bytes of the
    collectives dispatched inside it by kind (`COLLECTIVES`)."""
    got: Dict[str, float] = {}
    with Counter() as c:
        yield got
    got.update(c.totals()["collectives"])
