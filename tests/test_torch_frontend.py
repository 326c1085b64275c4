"""The port's binarize frontend (log-mel, ``wav2spec``, pitch) against the
JAX package on the same seeded signals.

Tolerances: the log-mel is float64 on both sides (the JAX binarizer's numpy
path), so 1e-5. Pitch candidates are float32 FFTs on both sides, held at
1e-4: absolute for the strengths (order 1), relative for the frequencies
(up to 750 Hz; the parabolic refinement divides by a second difference).
The tracked f0 is a Viterbi argmax over those candidates, so it is held by
the share of frames: within 1 Hz on >= 99% of frames, coarse pitch equal on
>= 99%.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from neuralsvb_tpu.hparams import hparams_scope as jax_scope  # noqa: E402
from neuralsvb_tpu.ops import pitch as JP  # noqa: E402
from neuralsvb_tpu.ops.stft import log_mel_np  # noqa: E402
from neuralsvb_tpu.vocoders.pwg import PWG as JPWG  # noqa: E402

from neuralsvb_torch.hparams import hparams_scope  # noqa: E402
from neuralsvb_torch.ops import pitch as TP  # noqa: E402
from neuralsvb_torch.ops.audio import save_wav  # noqa: E402
from neuralsvb_torch.ops.stft import log_mel  # noqa: E402
from neuralsvb_torch.vocoders import get_vocoder_cls  # noqa: E402

SR, HOP = 22050, 128
HP = dict(audio_sample_rate=SR, fft_size=512, hop_size=HOP, win_size=512,
          audio_num_mel_bins=80, fmin=50, fmax=11025)
CPU = torch.device("cpu")


def _rand_wav(n=22050, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.randn(n)).astype(np.float32)


def _tone(freq, dur=1.0, amp=0.3):
    t = np.arange(int(SR * dur)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _vibrato():
    t = np.arange(SR) / SR
    inst = 220 * (1 + 0.05 * np.sin(2 * np.pi * 5 * t))
    return (0.3 * np.sin(2 * np.pi * np.cumsum(inst) / SR)).astype(np.float32)


# the four signals of tests/test_pitch.py
SIGNALS = {
    "tone110": lambda: _tone(110.0), "tone220": lambda: _tone(220.0),
    "tone440": lambda: _tone(440.0),
    "silence": lambda: np.zeros(SR // 2, np.float32),
    "tone_with_silences": lambda: np.concatenate([
        np.zeros(SR // 4, np.float32), _tone(220, 0.5), np.zeros(SR // 4, np.float32)]),
    "vibrato": _vibrato,
}


@pytest.mark.parametrize("n,seed", [(22050, 0), (3001, 1)])
def test_log_mel_matches_numpy(n, seed):
    wav = _rand_wav(n, seed)
    ref = log_mel_np(wav, sample_rate=SR, fft_size=512, hop_size=HOP, win_size=512,
                     num_mels=80, fmin=50, fmax=11025)
    out = log_mel(wav, HP, CPU)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (1 + n // HOP, 80)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_wav2spec_length_contract(tmp_path):
    """``wav2spec`` of the registry's ``pwg`` entry (the binarize configs'
    vocoder): wav = frames x hop samples, and the same (wav, mel) as JAX;
    its ``spec2wav`` returns frames x hop samples."""
    wav = _rand_wav(10000, 3)
    fn = str(tmp_path / "x.wav")
    save_wav(wav, fn, SR)
    with hparams_scope(dict(HP, vocoder="pwg", device="cpu")) as h:
        cls = get_vocoder_cls(h)
        w, mel = cls.wav2spec(fn)
    assert cls.__name__ == "PWG"
    assert mel.shape == (1 + 10000 // HOP, 80) and len(w) == mel.shape[0] * HOP
    with jax_scope(dict(HP)):
        jw, jmel = JPWG.wav2spec(fn)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_allclose(mel, jmel, atol=1e-5)
    # the registry's PWG serves too: hop-128 scales in the vocoder loader's keys
    gen = {"layers": 2, "stacks": 1, "residual_channels": 8, "gate_channels": 16,
           "skip_channels": 8, "upsample_params": {"upsample_scales": [4, 4, 8]}}
    with hparams_scope(dict(HP, vocoder="pwg", device="cpu", generator_params=gen)):
        out = cls().spec2wav(mel)
    assert out.shape == (mel.shape[0] * HOP,) and bool(torch.isfinite(out).all())
    with hparams_scope(dict(HP, vocoder="pwg")):
        with pytest.raises(ValueError, match="device"):
            cls.wav2spec(fn)


@pytest.mark.parametrize("name", ["tone220", "tone_with_silences", "vibrato"])
def test_pitch_candidates_match_jax(name):
    wav = SIGNALS[name]() + 0.01 * np.random.RandomState(5).randn(
        len(SIGNALS[name]())).astype(np.float32)
    kw = dict(sr=SR, hop=HOP, f0_min=80.0, f0_max=750.0, frame_len=827,
              voicing_threshold=0.6)
    fj, sj = (np.asarray(x) for x in JP._pitch_candidates(jnp.asarray(wav), **kw))
    ft, st = (x.numpy() for x in TP._pitch_candidates(torch.as_tensor(wav), **kw))
    assert ft.shape == fj.shape == (1 + len(wav) // HOP, TP.K_CANDIDATES)
    valid = sj > -1e8
    np.testing.assert_array_equal(st > -1e8, valid)
    np.testing.assert_allclose(st, sj, atol=1e-4)
    # invalid slots carry no frequency the Viterbi can pick (strength -1e9)
    np.testing.assert_allclose(ft[valid], fj[valid], rtol=1e-4)


@pytest.mark.parametrize("name", list(SIGNALS))
def test_track_and_get_pitch_match_jax(name):
    wav = SIGNALS[name]()
    f0_t = TP.track_pitch(wav, SR, HOP, CPU)
    f0_j = JP.track_pitch(wav, SR, HOP)
    assert f0_t.shape == f0_j.shape and f0_t.dtype == np.float32
    assert np.mean(np.abs(f0_t - f0_j) <= 1.0) >= 0.99
    mel = np.zeros((1 + len(wav) // HOP, 80), np.float32)
    hp = {"hop_size": HOP, "audio_sample_rate": SR}
    f0_t, pitch_t = TP.get_pitch(wav, mel, hp, CPU)
    f0_j, pitch_j = JP.get_pitch(wav, mel, hp)
    assert f0_t.shape == pitch_t.shape == (len(mel),)
    assert (f0_t[:8] == 0).all()  # lpad frames for hop 128
    assert np.mean(np.abs(f0_t - f0_j) <= 1.0) >= 0.99
    assert np.mean(pitch_t == pitch_j) >= 0.99
