"""Shared plumbing for the port's kernels (the delivery-wheel kernels,
`majority_step`, and the training substrate's `threshold_gate`,
`rglru_scan` and `flash_attention_fwd`).

Every kernel module holds three things side by side: the CUDA
launch (a C function in ``kernels/csrc/<name>.cu``, bound with ctypes),
its plain PyTorch version (the semantics, used for CPU tensors and by
the engine when its kernels are switched off), and a launch count.

A wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._build import library

# launches of each kernel since the last `reset_launches` (the wrapper
# adds one exactly where it launches its kernel, nowhere else)
# ("threshold_step" is its majority form; the mean form, the two L2
# forms and `kernels.majority_step` count under their own names)
LAUNCHES: Dict[str, int] = {"stage_rows": 0, "threshold_step": 0,
                            "due_dedup": 0, "descent_tail": 0,
                            "threshold_step_mean": 0, "threshold_step_l2": 0,
                            "threshold_step_l2_general": 0,
                            "majority_step": 0, "threshold_gate": 0,
                            "rglru_scan": 0, "flash_attention_fwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check_args(kernel: str, tensors: Dict[str, torch.Tensor],
               dtypes: Dict[str, torch.dtype]) -> torch.device:
    """Raise unless every tensor is contiguous, of its required dtype and
    on the same CUDA device. Returns that device."""
    dev = None
    for name, t in tensors.items():
        if not on_cuda(t):
            raise ValueError(f"{kernel}: {name} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(
                f"{kernel}: {name} has dtype {t.dtype}, want {dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    return dev


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launch function `symbol` of ``csrc/<name>.cu``; it returns
    the `cudaGetLastError()` code of its launch."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_of(dev: torch.device) -> int:
    """The raw handle of `dev`'s current stream: what
    `torch.cuda.current_stream(dev).cuda_stream` gives, without building a
    Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if dev.index is None else dev.index)


def launched(kernel: str, rc: int) -> None:
    """Count one launch of `kernel`, or raise on a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1


P = ctypes.c_void_p  # device pointer / stream argument
I64 = ctypes.c_int64
I32 = ctypes.c_int32
U32 = ctypes.c_uint32
F32 = ctypes.c_float


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def in_segment(addr, a_prev, a_self):
    """Does `addr` fall in the ring segment (a_prev, a_self]? The wrapped
    (root) segment has a_prev >= a_self."""
    wrapped = a_prev >= a_self
    inside = (addr > a_prev) & (addr <= a_self)
    inside_wrap = (addr > a_prev) | (addr <= a_self)
    return torch.where(wrapped, inside_wrap, inside)
