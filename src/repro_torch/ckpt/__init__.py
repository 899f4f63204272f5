"""Checkpoints of the port's trees of tensors (`checkpoint`)."""
