"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision] — vision STUB.

40-layer llama backbone (d_model 4096, 32 heads GQA kv=8, d_ff 14336,
vocab 128256) with a gated cross-attention layer every 5th layer attending
to vision tokens. The vision tower is a stub: input_specs() provides
(B, 4100, 4096) projected patch embeddings (6404 in the hf config for 4
tiles; we use the single-tile 1601*... pool-assigned 4100).
Full attention => long_500k skipped.
"""
from .base import BlockDef, ModelConfig

_PAT = tuple([BlockDef("attn", "dense")] * 4 + [BlockDef("xattn", "dense")])

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128_256, pattern=_PAT,
    activation="silu", rope_theta=500_000.0, tie_embeddings=False,
    frontend="vision", n_frontend_tokens=4100, frontend_dim=4096,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, pattern=_PAT,
    activation="silu", rope_theta=500_000.0, tie_embeddings=False,
    frontend="vision", n_frontend_tokens=12, frontend_dim=32, dtype="float32",
)
