"""The port's distributed training pieces: threshold-gated pod sync
(`threshold_sync`)."""
