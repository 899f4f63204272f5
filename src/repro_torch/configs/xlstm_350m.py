"""xLSTM-350M [arXiv:2405.04517].

24 residual blocks in the xLSTM[7:1] ratio: 7 mLSTM blocks (matrix memory,
parallelizable, includes its own up/down projection — ffn='none') per
1 sLSTM block (scalar memory, sequential scan) followed by a gated FFN.
d_model 1024, 4 heads. Constant-size state => runs long_500k.
"""
from .base import BlockDef, ModelConfig

_PAT = tuple([BlockDef("mlstm", "none")] * 7 + [BlockDef("slstm", "dense")])

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=2731, vocab_size=50_304, pattern=_PAT,
    activation="gelu", gated_mlp=True, rope_theta=0.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    num_layers=8, d_model=32, num_heads=2, num_kv_heads=2,
    d_ff=64, vocab_size=512, pattern=_PAT,
    activation="gelu", rope_theta=0.0, tie_embeddings=True, dtype="float32",
)
