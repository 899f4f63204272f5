"""The port's distributed training pieces: threshold-gated pod sync
(`threshold_sync`), the gossip baseline (`gossip_sync`), the
expert-parallel MoE (`moe_ep`), the sharding plan (`sharding`) and
sequence sharding (`sp`)."""
