"""The port's GE2E speaker encoder (``neuralsvb_torch/models/ge2e.py``)
against the JAX package on the same weights: a seeded Resemblyzer-layout
checkpoint read by both sides (the JAX side through its own
``convert_ge2e``, see ``jax_ge2e_params``), and flax-initialized params
carried over with ``ge2e_from_jax``. Embeddings agree to 1e-5 (f32 LSTM on
both sides)."""

from __future__ import annotations

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralsvb_tpu.convert.torch2jax import convert_ge2e  # noqa: E402
from neuralsvb_tpu.models import ge2e as JG  # noqa: E402

from neuralsvb_torch.convert.jax2torch import ge2e_from_jax  # noqa: E402
from neuralsvb_torch.models import ge2e as TG  # noqa: E402

CPU = torch.device("cpu")


def jax_ge2e_params(path):
    """``convert_ge2e(path)`` in the tree the flax ``VoiceEncoder`` has.

    ``convert_ge2e`` names its layers ``lstm_{i}/cell``, but the flax model's
    params are ``OptimizedLSTMCell_{i}``, so the JAX package cannot apply
    what it converts (flax ``ScopeCollectionNotFound``). This renames the
    layers and changes nothing else."""
    p = convert_ge2e(path)
    return {**{f"OptimizedLSTMCell_{i}": p.pop(f"lstm_{i}")["cell"] for i in range(3)},
            **p}


def _wav(seconds, sr, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    vib = 230 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    return (0.3 * np.sin(2 * np.pi * np.cumsum(vib) / sr)
            + 0.02 * rng.randn(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_encoder():
    """One JAX encoder (flax-init params) for the module: its jitted forward
    takes the params as an argument, so every test reuses one compile."""
    return JG.SpeakerEncoder(None)


def _jax_embed(jax_encoder, params, wav, sr=16000):
    enc = copy.copy(jax_encoder)
    enc.params = params
    return enc.embed_utterance(wav, sr)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A Resemblyzer-named state dict of a seeded port encoder."""
    enc = TG.SpeakerEncoder(None, CPU, seed=3)
    path = tmp_path_factory.mktemp("ge2e") / "ge2e.pt"
    torch.save(enc.model.state_dict(), path)
    return str(path), enc


def test_ge2e_from_jax_round_trip(ckpt):
    path, enc = ckpt
    sd = enc.model.state_dict()
    back = ge2e_from_jax(jax_ge2e_params(path))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if "bias_ih" in k:  # flax folds both LSTM biases into one
            want = v + sd[k.replace("bias_ih", "bias_hh")]
        elif "bias_hh" in k:
            want = torch.zeros_like(v)
        else:
            want = v
        torch.testing.assert_close(back[k], want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("seconds,sr", [(2.3, 22050), (0.7, 16000)])
def test_embed_utterance_matches_jax(ckpt, jax_encoder, seconds, sr):
    path, _ = ckpt
    wav = _wav(seconds, sr, seed=int(seconds * 10))
    np.testing.assert_allclose(TG.wav_to_mel40(wav, sr, CPU).numpy(),
                               JG.wav_to_mel40(wav, sr), rtol=1e-5, atol=1e-6)
    e_t = TG.SpeakerEncoder(path, CPU).embed_utterance(wav, sr)
    e_j = _jax_embed(jax_encoder, jax_ge2e_params(path), wav, sr)
    assert e_t.shape == (256,) and e_t.dtype == np.float32
    np.testing.assert_allclose(e_t, e_j, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(e_t), 1.0, atol=1e-5)


def test_flax_init_params_carry_over(jax_encoder):
    """JAX's own ``SpeakerEncoder(None)`` weights through ``ge2e_from_jax``:
    this also fixes the gate order (i, f, g, o)."""
    params = jax.tree_util.tree_map(np.array, jax_encoder.params)
    enc = TG.SpeakerEncoder(None, CPU)
    enc.model.load_state_dict(ge2e_from_jax(params))
    wav = _wav(1.9, 16000, seed=4)
    np.testing.assert_allclose(enc.embed_utterance(wav),
                               jax_encoder.embed_utterance(wav), atol=1e-5)


def test_resemblyzer_checkpoint_loads(ckpt, tmp_path):
    """Resemblyzer's file keeps the state dict under ``model_state`` beside
    GE2E's similarity scale; both layouts load strictly."""
    path, enc = ckpt
    sd = enc.model.state_dict()
    wrapped = tmp_path / "pretrained.pt"
    torch.save({"model_state": dict(sd, similarity_weight=torch.tensor([10.0]),
                                    similarity_bias=torch.tensor([-5.0])),
                "step": 1}, wrapped)
    wav = _wav(1.1, 16000, seed=5)
    e = TG.SpeakerEncoder(str(wrapped), CPU).embed_utterance(wav)
    np.testing.assert_array_equal(e, enc.embed_utterance(wav))
    assert set(TG.load_ge2e_state_dict(path)) == set(sd)
    with pytest.raises(RuntimeError, match="Missing key"):
        TG.VoiceEncoder().load_state_dict({k: v for k, v in sd.items() if k != "linear.bias"})
