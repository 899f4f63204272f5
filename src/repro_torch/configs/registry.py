"""Architecture registry of the port: --arch <id> -> (full config,
reduced smoke config). The ids are the reference's (`ARCH_IDS`), every
one of them ported."""
from __future__ import annotations

import importlib

from .base import ModelConfig, ShapeConfig

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


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of this cell (the
    reference's ``ShapeDtypeStruct`` tree; nothing is allocated):

    train:   {tokens, targets [, frontend_embeds]}
    prefill: {tokens [, frontend_embeds]}
    decode:  {token, cache} (one new token against a seq_len-deep cache)
    """
    import torch

    from repro_torch.models.model import make_cache

    b, s = shape.global_batch, shape.seq_len
    tok = lambda n: torch.empty((b, n), dtype=torch.int32, device="meta")
    out = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = tok(s)
        if shape.kind == "train":
            out["targets"] = tok(s)
        if cfg.frontend:
            out["frontend_embeds"] = torch.empty(
                (b, cfg.n_frontend_tokens, cfg.frontend_dim),
                dtype=cfg.torch_dtype, device="meta")
    else:
        out["token"] = tok(1)
        out["cache"] = make_cache(cfg, b, s, device="meta")
    return out
