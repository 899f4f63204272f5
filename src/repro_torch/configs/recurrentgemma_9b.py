"""RecurrentGemma-9B (Griffin architecture) [arXiv:2402.19427].

38 layers in a (rec, rec, swa) repeating pattern — two RG-LRU recurrent
blocks per local-attention block (window 2048), MQA (1 kv head),
GeGLU MLP, head_dim 256, vocab 256k, embeddings scaled by sqrt(d).
Bounded decode state => runs the long_500k cell.
"""
from .base import BlockDef, ModelConfig

_PAT = (BlockDef("rglru", "dense"), BlockDef("rglru", "dense"), BlockDef("swa", "dense"))

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256_000, pattern=_PAT,
    norm="rmsnorm_unit", activation="gelu", gated_mlp=True,
    rope_theta=10_000.0, window=2048, rec_width=4096,
    emb_scale=4096.0 ** 0.5, logit_softcap=30.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, pattern=_PAT,
    norm="rmsnorm_unit", activation="gelu", gated_mlp=True,
    rope_theta=10_000.0, window=16, rec_width=64,
    emb_scale=8.0, logit_softcap=30.0, tie_embeddings=True, dtype="float32",
)
