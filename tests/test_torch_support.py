"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Every parity test builds a port module from a seed, carries its
``state_dict`` into the JAX package with ``neuralsvb_tpu.convert.torch2jax``,
feeds both the same numpy inputs and compares the outputs. Stochastic sites
are zero on both sides: the port takes ``zero_noise=True`` (an explicit
argument), the JAX side runs inside ``jax_zero_noise()``, which patches the
JAX RNG draws to zeros for the duration of the test only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402


@contextlib.contextmanager
def jax_zero_noise():
    """jax.random.normal / uniform return zeros inside the block."""
    normal, uniform = jax.random.normal, jax.random.uniform
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype)
    jax.random.uniform = (lambda key, shape=(), dtype=jnp.float32, minval=0.0,
                          maxval=1.0: jnp.zeros(shape, dtype))
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform = normal, uniform


def seeded(ctor, seed: int = 0):
    """Build a torch module with seeded default init, then give every
    BatchNorm non-trivial running statistics (also from the seed)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        m = ctor()
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.normal_(0.0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
                mod.weight.data.uniform_(0.5, 1.5)
                mod.bias.data.normal_(0.0, 0.2)
    return m.eval()


def sd_numpy(module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def flax_load(model, init_args, init_kwargs, params, stats=None):
    """Init the flax model for its tree, then overwrite with converted
    weights (``from_state_dict`` checks the structure)."""
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    variables = model.init(rngs, *init_args, **init_kwargs)
    out = {"params": serialization.from_state_dict(variables["params"], params)}
    if variables.get("batch_stats"):
        out["batch_stats"] = serialization.from_state_dict(
            variables["batch_stats"], stats)
    return out


def agree(a, b, tol, name=""):
    """max |a - b| <= tol, the JAX package's own parity criterion."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    d = float(np.abs(a - b).max())
    assert d <= tol, f"{name}: max |d| = {d:.3e} > {tol}"


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module of tiny-width tests: the test
    workers share the host's cores, and torch's default of one thread per
    core makes them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
