"""The port's model: layers (`layers`), assembly and loss (`model`), and
the JAX parameter-tree converter (`convert`)."""
