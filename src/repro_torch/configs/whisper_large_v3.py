"""Whisper large-v3 [arXiv:2212.04356] — encoder-decoder, audio frontend STUB.

32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA), d_ff 5120,
GELU (non-gated), LayerNorm, sinusoidal positions (rope_theta=0), vocab
51866. The conv mel frontend is a stub: input_specs() provides precomputed
(B, 1500, 1280) frame embeddings. Decode shapes lower the DECODER step
(self-attn cache + cross-attn to the 1500 cached encoder states).
Full attention => long_500k skipped.
"""
from .base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51_866,
    pattern=(BlockDef("dec", "dense"),),
    enc_layers=32, enc_pattern=(BlockDef("bidir", "dense"),),
    norm="layernorm", activation="gelu", gated_mlp=False,
    rope_theta=0.0, attn_bias=True, tie_embeddings=True,
    frontend="audio", n_frontend_tokens=1500, frontend_dim=1280,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    pattern=(BlockDef("dec", "dense"),),
    enc_layers=2, enc_pattern=(BlockDef("bidir", "dense"),),
    norm="layernorm", activation="gelu", gated_mlp=False,
    rope_theta=0.0, attn_bias=True, tie_embeddings=True,
    frontend="audio", n_frontend_tokens=24, frontend_dim=64, dtype="float32",
)
