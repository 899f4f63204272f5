"""Gemma-7B [arXiv:2403.08295].

28 layers, d_model 3072, 16 heads (kv=16 on 7b; MQA is the 2b variant),
head_dim 256, GeGLU with d_ff 24576, vocab 256k, RMSNorm with unit offset,
embeddings scaled by sqrt(d). Full attention => long_500k skipped.
"""
from .base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256_000,
    pattern=(BlockDef("attn", "dense"),),
    norm="rmsnorm_unit", activation="gelu",
    rope_theta=10_000.0, tie_embeddings=True, emb_scale=3072.0 ** 0.5,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    pattern=(BlockDef("attn", "dense"),),
    norm="rmsnorm_unit", activation="gelu",
    rope_theta=10_000.0, tie_embeddings=True, emb_scale=8.0, dtype="float32",
)
