"""Host-side utilities of the port: text encoders and evaluation metrics
(numpy and scipy; no torch, no JAX)."""
