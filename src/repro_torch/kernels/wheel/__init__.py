"""The delivery wheel's four per-cycle kernels, written in CUDA for Hopper.

  * `stage_rows`     — DELIVER_T stamping of the cycle's staged appends;
  * `threshold_step` — the fused Alg. 3 test/Send step (majority, mean
    and L2 forms);
  * `due_dedup`      — the accept election (winner/rep/alert force);
  * `descent_tail`   — the R1 internal-descent tail.

Each module holds the wrapper, its plain PyTorch version
(`*_reference`) and the launch count (`_common.LAUNCHES`). The engine's
``wheel_kernels`` option names the enabled subset of `WHEEL_KERNELS`.
"""
from repro_torch.kernels.wheel._common import (LAUNCHES, launch_counts,
                                               reset_launches)
from repro_torch.kernels.wheel.descent import descent_reference, descent_tail
from repro_torch.kernels.wheel.due_dedup import due_dedup, due_dedup_reference
from repro_torch.kernels.wheel.enqueue import stage_rows, stage_rows_reference
from repro_torch.kernels.wheel.threshold_step import (threshold_step,
                                                      threshold_step_reference)

WHEEL_KERNELS = ("dedup", "enqueue", "descent", "threshold")

__all__ = [
    "LAUNCHES", "WHEEL_KERNELS", "descent_reference", "descent_tail",
    "due_dedup", "due_dedup_reference", "launch_counts", "reset_launches",
    "stage_rows", "stage_rows_reference", "threshold_step",
    "threshold_step_reference",
]
