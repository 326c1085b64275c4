"""Host-side ops and the CUDA kernels' wrappers."""
