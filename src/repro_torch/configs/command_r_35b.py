"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

40 layers, d_model 8192, 64 heads GQA kv=8 (hf config: 64 q heads; the
released model uses MQA-ish kv groups), d_ff 22528, vocab 256k, LayerNorm
(no bias per config note), rope theta 8e6, tied embeddings + logit scale.
Full attention => long_500k skipped.
"""
from .base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256_000,
    pattern=(BlockDef("attn", "dense"),),
    norm="layernorm", activation="silu", attn_bias=False,
    rope_theta=8_000_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=160, vocab_size=512,
    pattern=(BlockDef("attn", "dense"),),
    norm="layernorm", activation="silu",
    rope_theta=8_000_000.0, tie_embeddings=True, dtype="float32",
)
