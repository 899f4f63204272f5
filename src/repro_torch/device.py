"""Where the port runs: CUDA unless the caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device for an entry point: CUDA unless the caller names
    another. Raises when CUDA is asked for and absent — never falls back
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev
