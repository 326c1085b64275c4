"""Neural network modules of the port ([B, C, T] inside)."""
