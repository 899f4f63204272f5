"""Architecture registry of the port: --arch <id> -> (full config,
reduced smoke config). The ids are the reference's (`ARCH_IDS`); only
the architectures whose layers are ported resolve, every other id
raises `NotImplementedError` naming ROADMAP.md §A8."""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = (
    "recurrentgemma-9b",
    "smollm-135m",
    "command-r-35b",
    "minicpm-2b",
    "gemma-7b",
    "deepseek-v3-671b",
    "arctic-480b",
    "xlstm-350m",
    "whisper-large-v3",
    "llama-3.2-vision-11b",
)
PORTED = ("recurrentgemma-9b", "smollm-135m", "command-r-35b", "minicpm-2b",
          "gemma-7b", "deepseek-v3-671b", "arctic-480b", "whisper-large-v3",
          "llama-3.2-vision-11b")


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP.md §A8: the other registry "
            f"architectures and their layers); ported: {', '.join(PORTED)}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
