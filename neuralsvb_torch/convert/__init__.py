"""Weight conversion between the port and the JAX package, and reading of
reference-format torch checkpoints."""
