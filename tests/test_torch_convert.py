"""Weight round trip between the port and the JAX package at tiny widths:
port state_dict -> ``torch2jax`` -> JAX params -> ``jax2torch`` -> the same
state_dict, bit for bit, for MleSVBVAE and HiFiGAN-NSF; the JAX params load
into the flax models."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_support import flax_load, seeded  # noqa: E402
from tests.test_torch_svb_vae import TINY, jax_svbvae, svbvae_inputs  # noqa: E402

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.models.hifigan import HifiGanGenerator as JGen  # noqa: E402
from neuralsvb_torch.convert import jax2torch  # noqa: E402
from neuralsvb_torch.models.hifigan import HifiGanGenerator as TGen  # noqa: E402
from neuralsvb_torch.models.svb_vae import SVBVAE  # noqa: E402


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(sd_a, sd_b):
    assert sorted(sd_a) == sorted(sd_b), set(sd_a) ^ set(sd_b)
    for k in sd_a:
        a, b = sd_a[k], sd_b[k]
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape)
        assert torch.equal(a, b), k


def test_svbvae_mle_round_trip():
    tm = seeded(lambda: SVBVAE(20, **TINY), 7)
    jm, params, stats = jax_svbvae(tm)
    inputs = svbvae_inputs()
    jin = tuple(a.astype(np.int32) if a.dtype == np.int64 else a for a in inputs)
    flax_load(jm, jin, dict(concurrent_ways=("a2a", "p2p", "a2p")), params, stats)
    back = jax2torch.svbvae_mle_from_jax(_numpy_tree(params), _numpy_tree(stats))
    _assert_same(tm.state_dict(), back)
    fresh = SVBVAE(20, **TINY)
    fresh.load_state_dict(back, strict=True)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_round_trip(tmp_path, resblock):
    kw = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
              upsample_initial_channel=32, resblock=resblock,
              resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3, 5),) * 2 if resblock == "1"
              else ((1, 3),) * 2)
    tm = seeded(lambda: TGen(**kw), 8)
    path = str(tmp_path / "model_ckpt_steps_1.ckpt")
    torch.save({"state_dict": {"model_gen": tm.state_dict()}}, path)
    jm = JGen(**kw, fuse_resblocks="off")
    params = t2j.convert_hifigan(path, jm)
    mel, f0 = np.zeros((1, 8, 80), np.float32), np.zeros((1, 8), np.float32)
    flax_load(jm, (mel, f0), {}, params)
    back = jax2torch.hifigan_from_jax(_numpy_tree(params))
    _assert_same(tm.state_dict(), back)
