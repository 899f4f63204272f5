"""GQA attention, causal, sliding-window or non-causal (encoder
self-attention, cross-attention with Sq != Skv and ragged key lengths):
`flash_attention_fwd` (the CUDA kernel on the card, the plain pair
schedule on the CPU), the differentiable `flash_attention`, the plain
versions `pair_fwd`, `pair_bwd` and `mha_reference`, and the
single-token decode over a KV cache, `decode_attention` (plain PyTorch,
as in the reference)."""
from repro_torch.kernels.flash_attention.ops import (cache_attention,
                                                     decode_attention,
                                                     flash_attention,
                                                     flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.flash_attention.xla_ref import pair_bwd, pair_fwd

__all__ = ["cache_attention", "decode_attention", "flash_attention",
           "flash_attention_fwd", "mha_reference", "pair_bwd", "pair_fwd"]
