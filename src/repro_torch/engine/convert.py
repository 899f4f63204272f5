"""State conversion between the port and host numpy arrays.

`state_from_numpy` builds a `DeviceState` from a dict of numpy arrays
keyed by field name — for instance the reference engine's state, handed
over as ``{k: np.asarray(v) for k, v in jax_eng._st._asdict().items()}``
— so both engines can start from the same state; the port itself never
touches jax. uint32 fields become int64 tensors holding the same values;
`state_to_numpy` converts back to the reference's dtypes, checking that
every 32-bit field still holds a 32-bit value. Shapes pass through as
they are: the row width of `wheel` / `awheel` (P + 6: 8 for majority and
mean, 9 for L2 with D = 2) and the payload widths of `inbox` / `out` are
the problem's, and `TorchEngine._adopt` checks them against its sizing.

A batched engine's state (B trials on one trial axis, see
`torch_backend.stack_trials`) converts per trial: `trials_to_numpy`
gives B dicts in the reference's single-trial layout — what
``{k: np.asarray(v[b]) for k, v in batched_jax._st._asdict().items()}``
gives for the reference's vmapped state — and `trials_from_numpy` stacks
B such dicts back.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.engine.torch_backend import (M32, U32_FIELDS, DeviceState,
                                             stack_trials, trial_state)

_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device="cpu") -> DeviceState:
    """`DeviceState` on `device` from numpy arrays of the reference's
    dtypes (uint32 for addresses, wheel rows and the salt; int32; bool)."""
    missing = set(DeviceState._fields) - set(arrays)
    if missing:
        raise KeyError(f"state lacks fields {sorted(missing)}")
    out = {}
    for k in DeviceState._fields:
        a = np.asarray(arrays[k])
        if k in U32_FIELDS:
            if a.dtype != np.uint32:
                raise TypeError(f"{k}: want uint32, got {a.dtype}")
            t = torch.from_numpy(a.astype(np.int64))
        elif a.dtype in _DTYPES:
            t = torch.from_numpy(np.array(a))
        else:
            raise TypeError(f"{k}: unsupported dtype {a.dtype}")
        out[k] = t.to(device)
    return DeviceState(**out)


def state_to_numpy(state: DeviceState) -> Dict[str, np.ndarray]:
    """Host copy of `state` in the reference's dtypes."""
    out = {}
    for k in DeviceState._fields:
        t = getattr(state, k).detach()
        # a copy, never a view of the live tensor (on the CPU, .numpy()
        # alone shares its memory)
        a = t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
        if k in U32_FIELDS:
            if a.size and (a.min() < 0 or a.max() > M32):
                raise ValueError(f"{k} holds a value outside 32 bits")
            a = a.astype(np.uint32)
        out[k] = a
    return out


def trials_to_numpy(state: DeviceState, batch: int) -> List[Dict[str, np.ndarray]]:
    """Host copies of each trial of a `batch`-trial state, each in the
    reference's single-trial layout and dtypes."""
    return [state_to_numpy(trial_state(state, b, batch)) for b in range(batch)]


def trials_from_numpy(arrays: Sequence[Dict[str, np.ndarray]],
                      device="cpu") -> DeviceState:
    """A B-trial `DeviceState` from B single-trial dicts (reference
    layout and dtypes), in trial order."""
    return stack_trials([state_from_numpy(a, device) for a in arrays])
