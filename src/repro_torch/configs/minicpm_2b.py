"""MiniCPM-2B [arXiv:2404.06395]: llama-like with mu-p-style scaling and a
WSD (warmup-stable-decay) LR schedule — the schedule lives in
repro_torch.optim.schedules and is selected by this config's `train` extras.

40 layers, d_model 2304, 36 heads (kv=36 — full MHA), d_ff 5760,
vocab 122753. Full attention => long_500k skipped.
"""
from .base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122_753,
    pattern=(BlockDef("attn", "dense"),),
    activation="silu", rope_theta=10_000.0, tie_embeddings=True,
    emb_scale=12.0,
)

# training extras (MiniCPM's WSD schedule)
SCHEDULE = dict(kind="wsd", warmup=0.01, stable=0.89, decay=0.10)

SMOKE = ModelConfig(
    name="minicpm-smoke", family="dense",
    num_layers=4, d_model=48, num_heads=6, num_kv_heads=6,
    d_ff=96, vocab_size=512,
    pattern=(BlockDef("attn", "dense"),),
    activation="silu", rope_theta=10_000.0, tie_embeddings=True,
    emb_scale=12.0, dtype="float32",
)
