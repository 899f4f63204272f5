"""Error-feedback threshold compression: `threshold_gate` (the CUDA
kernel on the card, the plain version on the CPU) and its plain version
`threshold_gate_reference`."""
from repro_torch.kernels.threshold_gate.ops import threshold_gate
from repro_torch.kernels.threshold_gate.ref import threshold_gate_reference

__all__ = ["threshold_gate", "threshold_gate_reference"]
