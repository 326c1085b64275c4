"""The benchmark's plain reference: the modules the cells run, in plain
PyTorch float32 with no kernel, frozen here so that a later change to the
program cannot move the yardstick it is judged by. Imports nothing of the
program (``neuralsvb_torch``) and nothing of JAX."""
