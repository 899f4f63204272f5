"""Config schema of the architectures (a copy of `repro.configs.base`'s
`MoEConfig`, `MLAConfig`, `BlockDef` and `ModelConfig` with torch
dtypes).

A `ModelConfig` fully determines parameters and computation. Layer
stacking is a repeating *pattern* of `BlockDef`s (mixer + FFN kind);
`segments()` turns (num_layers, pattern, first_dense_layers) into
segments of homogeneous periods, exactly as the reference does. The
reference scans each segment with ``lax.scan``; the port loops over its
periods.

One field differs: the reference's ``use_pallas`` (off by default,
since its kernels need a TPU) is ``use_kernels`` here, on by default.
With it, CUDA tensors go through the hand-written kernels
(`flash_attention_fwd`, `rglru_scan`); without it, through their plain
PyTorch versions on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    n_shared: int = 0  # shared-expert multiplier (DeepSeek: 1)
    capacity_factor: float = 1.25
    router: str = "softmax"  # 'softmax' | 'sigmoid' (DeepSeek aux-free)
    impl: str = "gather"  # 'gather'; 'ep_a2a' (expert-parallel
    # all-to-all dispatch, `distributed.moe_ep`, where a mesh is set)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer's recipe: a mixer ('attn', 'swa', 'bidir', 'xattn',
    'dec', 'mla', 'rglru', 'mlstm', 'slstm') and an FFN ('dense', 'moe',
    'dense_moe', or 'none': the xLSTM mLSTM blocks' own)."""

    mixer: str
    ffn: str = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockDef, ...] = (BlockDef("attn", "dense"),)
    head_dim: int = 0  # 0 -> d_model // num_heads
    norm: str = "rmsnorm"  # 'rmsnorm' | 'rmsnorm_unit' (1 + w) | 'layernorm'
    activation: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10_000.0  # 0: no rope, sinusoidal positions
    window: Optional[int] = None  # for 'swa'
    attn_bias: bool = False
    qk_norm: bool = False
    attn_scale: Optional[float] = None
    attn_softcap: Optional[float] = None
    emb_scale: Optional[float] = None
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = True
    rec_width: int = 0  # RG-LRU width (0 -> d_model)
    rglru_c: float = 8.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    first_dense_layers: int = 0  # DeepSeek's leading dense layers
    enc_layers: int = 0
    enc_pattern: Tuple[BlockDef, ...] = (BlockDef("bidir", "dense"),)
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    seq_shard: bool = False
    mtp: bool = False
    mtp_weight: float = 0.3
    use_kernels: bool = True  # the reference's use_pallas, on by default
    remat: str = "none"
    dtype: str = "bfloat16"
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def segments(self) -> Tuple[Tuple[Tuple[BlockDef, ...], int], ...]:
        """((pattern, n_periods), ...) covering all `num_layers` layers."""
        segs = []
        layers_left = self.num_layers
        if self.first_dense_layers:
            lead = tuple(
                dataclasses.replace(b, ffn="dense") if b.ffn != "none" else b
                for b in self.pattern
            )
            assert len(lead) == 1, "first_dense_layers expects a 1-block pattern"
            segs.append((lead, self.first_dense_layers))
            layers_left -= self.first_dense_layers
        p = len(self.pattern)
        full, rem = divmod(layers_left, p)
        if full:
            segs.append((self.pattern, full))
        if rem:
            segs.append((self.pattern[:rem], 1))
        return tuple(segs)

    def enc_segments(self):
        """The encoder's ((pattern, n_periods), ...); () without one."""
        if not self.enc_layers:
            return ()
        p = len(self.enc_pattern)
        full, rem = divmod(self.enc_layers, p)
        segs = []
        if full:
            segs.append((self.enc_pattern, full))
        if rem:
            segs.append((self.enc_pattern[:rem], 1))
        return tuple(segs)



@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True if every mixer has bounded decode state (runs long_500k)."""
    bounded = {"swa", "rglru", "mlstm", "slstm"}
    return all(b.mixer in bounded for b in cfg.pattern) and not cfg.enc_layers
