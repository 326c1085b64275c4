"""NeuralSVB in PyTorch for NVIDIA Hopper: a port of ``neuralsvb_tpu``.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's layout and class names (``neuralsvb_torch/models/svb_vae.py``
<-> ``neuralsvb_tpu/models/svb_vae.py``) and is held against it by the
``tests/test_torch_*.py`` suite. This package imports ``torch`` and never
``jax``. Inside the modules tensors are ``[B, C, T]``; public entry points
keep the JAX package's ``[B, T, C]`` layout.
"""

__version__ = "0.1.0"
