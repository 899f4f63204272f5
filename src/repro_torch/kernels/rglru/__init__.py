"""The RG-LRU recurrence h_t = a_t h_{t-1} + u_t: `rglru_scan` (the CUDA
kernel on the card, the plain version on the CPU), the differentiable
`linear_scan`, and the plain `linear_scan_reference` and `rglru_gates`."""
from repro_torch.kernels.rglru.ops import linear_scan, rglru_scan
from repro_torch.kernels.rglru.ref import linear_scan_reference, rglru_gates

__all__ = ["linear_scan", "linear_scan_reference", "rglru_gates",
           "rglru_scan"]
