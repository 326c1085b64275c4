"""MelGAN on the PyTorch port against the JAX package
(``neuralsvb_tpu/models/melgan.py``): the generator with reflect and zero
padding, non-causal and causal, at two upsample-scale sets (one with an odd
scale, whose transposed-conv crop differs), and the multi-scale
discriminator at its fixed widths. Flax initializes the JAX models, every
leaf gets seeded noise, and ``melgan_from_jax``/``melgan_disc_from_jax``
carry the weights into the port; the generator's state_dict also goes back
through the JAX package's ``convert_melgan_generator``. Outputs within 1e-4;
``melgan_stream`` against the whole-utterance output of the same causal
generator within 1e-5."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_pwg import noisy  # noqa: E402
from tests.test_torch_support import agree  # noqa: E402

from neuralsvb_tpu.convert.torch2jax import convert_melgan_generator  # noqa: E402
from neuralsvb_tpu.models import melgan as jmelgan  # noqa: E402
from neuralsvb_torch.convert.jax2torch import melgan_disc_from_jax, melgan_from_jax  # noqa: E402
from neuralsvb_torch.models import melgan as tmelgan  # noqa: E402

CH = 32


def _pair(scales, pad_mode, causal, seed):
    kw = dict(channels=CH, upsample_scales=scales, stacks=2, pad_mode=pad_mode,
              use_causal_conv=causal)
    jm = jmelgan.MelGANGenerator(**kw)
    params = jm.init(jax.random.PRNGKey(seed), np.zeros((1, 16, 80), np.float32))["params"]
    params = noisy(params, np.random.RandomState(seed), 0.05)
    tm = tmelgan.MelGANGenerator(**kw)
    tm.load_state_dict(melgan_from_jax(params, causal))  # strict: every name present
    return jm, params, tm.eval()


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("scales", [(4, 4), (3, 2, 2)], ids=["4x4", "3x2x2"])
def test_generator_matches_jax(scales, pad_mode, causal):
    jm, params, tm = _pair(scales, pad_mode, causal, seed=len(scales) + 2 * causal)
    rng = np.random.RandomState(7)
    T = 20
    mel = (rng.randn(2, T, 80) - 2).astype(np.float32)
    with torch.no_grad():
        wav_t = tm(torch.tensor(mel).transpose(1, 2))
    assert wav_t.shape == (2, T * int(np.prod(scales)))
    agree(wav_t, jm.apply({"params": params}, mel), 1e-4,
          f"MelGAN wav ({scales}, {pad_mode}, causal={causal})")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_melgan_generator(sd, scales, 2, causal)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def test_stream_equals_whole_utterance():
    _, _, tm = _pair((4, 4), "reflect", True, seed=9)
    mel = torch.tensor((np.random.RandomState(8).randn(1, 80, 70) - 2).astype(np.float32))
    with torch.no_grad():
        whole = tm(mel)
        streamed = tmelgan.melgan_stream(tm, mel, chunk=16, context=24)
    assert streamed.shape == whole.shape == (1, 70 * 16)
    agree(streamed, whole.numpy(), 1e-5, "melgan_stream")
    with pytest.raises(ValueError, match="causal"):
        tmelgan.melgan_stream(_pair((4, 4), "reflect", False, 9)[2], mel)


def test_multiscale_discriminator_matches_jax():
    rng = np.random.RandomState(11)
    x = (0.3 * rng.randn(2, 2048)).astype(np.float32)
    jd = jmelgan.MelGANMultiScaleDiscriminator()
    params = noisy(jd.init(jax.random.PRNGKey(3), x)["params"], rng, 0.01)
    td = tmelgan.MelGANMultiScaleDiscriminator()
    td.load_state_dict(melgan_disc_from_jax(params))
    with torch.no_grad():
        outs_t = td(torch.tensor(x))
    outs_j = jd.apply({"params": params}, x)
    assert len(outs_t) == len(outs_j) == 3
    for s, ((score_t, fm_t), (score_j, fm_j)) in enumerate(zip(outs_t, outs_j)):
        agree(score_t, score_j, 1e-4, f"scale {s} score")
        assert len(fm_t) == len(fm_j) == 7
        for i, (a, b) in enumerate(zip(fm_t, fm_j)):
            agree(a.transpose(1, 2), b, 1e-4, f"scale {s} fmap {i}")
