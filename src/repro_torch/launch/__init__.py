"""The port's training entry points (`train`) and train step
(`steps`)."""
