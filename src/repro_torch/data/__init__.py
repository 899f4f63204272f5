"""The port's data pipeline (a numpy copy of `repro.data`)."""
