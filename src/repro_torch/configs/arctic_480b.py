"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every one of the 35 layers runs a dense residual MLP
(d_ff 4864, as the reference's config) IN PARALLEL with a 128-expert
top-2 MoE (expert d_ff 4864).
56 heads GQA kv=8, d_model 7168, vocab 32000.
Full attention.
"""
from .base import BlockDef, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32_000,
    pattern=(BlockDef("attn", "dense_moe"),),
    activation="silu", rope_theta=10_000.0, tie_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, n_shared=0,
                  capacity_factor=1.25, router="softmax"),
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=96, vocab_size=512,
    pattern=(BlockDef("attn", "dense_moe"),),
    activation="silu", rope_theta=10_000.0, tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=96, n_shared=0,
                  capacity_factor=1.5, router="softmax"),
    dtype="float32",
)
