"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small model.

30 layers, d_model 576, 9 heads with GQA kv=3, SwiGLU d_ff 1536,
vocab 49152, tied embeddings. Full attention => long_500k skipped.
"""
from .base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49_152,
    pattern=(BlockDef("attn", "dense"),),
    activation="silu", rope_theta=10_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    num_layers=4, d_model=48, num_heads=3, num_kv_heads=1,
    d_ff=128, vocab_size=512,
    pattern=(BlockDef("attn", "dense"),),
    activation="silu", rope_theta=10_000.0, tie_embeddings=True, dtype="float32",
)
