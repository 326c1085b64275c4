"""Host-side text utilities of the port (no torch, no JAX)."""
