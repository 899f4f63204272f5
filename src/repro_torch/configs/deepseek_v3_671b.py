"""DeepSeek-V3 671B [arXiv:2412.19437].

61 layers of MLA attention (q_lora 1536, kv_lora 512, nope 128 + rope 64,
v_head 128, 128 heads); FFN: first 3 layers dense (d_ff 18432), the rest
MoE with 1 shared + 256 routed experts (top-8, sigmoid router with aux-free
bias balancing), expert d_ff 2048. Vocab 129280. The reference provides
MTP as an optional extra head (``mtp=True``: `models.model.lm_loss`). Full
attention (compressed cache, but per-step decode is still O(context)).

d_ff 2048 is the MoE expert width; the dense d_ff of the first three
layers is 18432, per the paper.
"""
from .base import BlockDef, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129_280,
    pattern=(BlockDef("mla", "moe"),), first_dense_layers=3,
    activation="silu", rope_theta=10_000.0, tie_embeddings=False,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  capacity_factor=1.25, router="sigmoid"),
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=512,
    pattern=(BlockDef("mla", "moe"),), first_dense_layers=1,
    activation="silu", rope_theta=10_000.0, tie_embeddings=False,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                  capacity_factor=1.5, router="sigmoid"),
    dtype="float32",
)
