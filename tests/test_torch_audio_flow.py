"""The small modules of the PyTorch port against the JAX package: the host
audio helpers (dB and normalisation, ``istft``, Griffin-Lim,
``trim_long_silences``), ``wav2spec(return_linear=True)``, the vocoder
denoiser on its device, the residual coupling flow (forward and reverse),
the FVAE with its prior flow (training and inference branches),
``TechClassifier`` and the discriminator's ``sum``/``none`` reductions.
Weights come from the JAX init (the flows' zero-initialised ``post`` convs
made random first) through ``convert.jax2torch``. Tolerances: 1e-5 for the
flows and the FVAE (``tests/test_models2.py::test_glow_invertible``'s),
1e-4 for the audio paths (the vocoder's), equality for the host numpy
copies and the silence masks. Last, the JAX ``SVBVAE(use_prior_glow=True)``
fails at its first forward (it gives its FVAE no glow widths), and the
port's refuses it, naming the lines."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_support import agree, jax_zero_noise, one_torch_thread  # noqa: E402,F401

from neuralsvb_tpu.models import disc as jdisc  # noqa: E402
from neuralsvb_tpu.models import fvae as jfvae  # noqa: E402
from neuralsvb_tpu.models import glow as jglow  # noqa: E402
from neuralsvb_tpu.ops import audio as jaudio  # noqa: E402
from neuralsvb_tpu.ops import stft as jstft  # noqa: E402
from neuralsvb_torch.convert import jax2torch as j2t  # noqa: E402
from neuralsvb_torch.models import disc as tdisc  # noqa: E402
from neuralsvb_torch.models import fvae as tfvae  # noqa: E402
from neuralsvb_torch.models import glow as tglow  # noqa: E402
from neuralsvb_torch.ops import audio as taudio  # noqa: E402
from neuralsvb_torch.ops import stft as tstft  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 22050
STFT = dict(fft_size=512, hop_size=128, win_size=512, min_level_db=-100,
            griffin_lim_iters=3)
B, H, LAT, T = 2, 16, 8, 24


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _randomized(tree, seed, scale=0.3):
    """Every leaf of ``tree`` replaced by seeded normal values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * scale).astype(np.float32), _np_tree(tree))


def _sung(seconds, seed=0, silences=()):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    wav = wav + 0.01 * rng.randn(len(t))
    for a, b in silences:
        wav[int(a * SR):int(b * SR)] = 1e-4 * rng.randn(int(b * SR) - int(a * SR))
    return wav.astype(np.float32)


def test_db_helpers_and_istft_are_the_jax_ones():
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(33, 20)) + 1e-6
    for f in ("amp_to_db", "db_to_amp"):
        np.testing.assert_array_equal(getattr(taudio, f)(x), getattr(jaudio, f)(x))
    for f in ("normalize", "denormalize"):
        np.testing.assert_array_equal(getattr(taudio, f)(x, STFT), getattr(jaudio, f)(x, STFT))
    spec = rng.randn(257, 30) + 1j * rng.randn(257, 30)
    np.testing.assert_array_equal(tstft.istft(spec, 128, 512), jstft.istft_np(spec, 128, 512))
    wav = _sung(0.5)
    np.testing.assert_array_equal(tstft.stft_mag_np(wav, 512, 128, 512),
                                  jstft.stft_mag_np(wav, 512, 128, 512))


def test_griffin_lim_matches_jax():
    wav = _sung(0.4, 1)
    S = jstft.stft_mag_np(wav, 512, 128, 512)
    angles = np.exp(2j * np.pi * np.random.RandomState(2).rand(*S.shape))
    np.testing.assert_allclose(taudio.griffin_lim(S, STFT, angles),
                               jaudio.griffin_lim(S, STFT, angles), atol=1e-12)


def test_trim_long_silences_same_mask():
    wav = _sung(3.0, 3, silences=((0.8, 1.9), (2.5, 2.7)))
    t_wav, t_mask, _ = taudio.trim_long_silences(wav, SR)
    j_wav, j_mask, _ = jaudio.trim_long_silences(wav, SR)
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_wav, j_wav)
    assert 0 < t_mask.sum() < len(wav)  # the long silence goes, the short one stays


def test_denoiser_matches_jax():
    wav = _sung(0.6, 4)[: 100 * 128]  # a vocoder's wav: frames x hop
    for c in (0.01, 0.1):
        got = tstft.spectral_subtract(torch.tensor(wav), 512, 128, 512, c)
        want = jaudio.denoise_spectral_subtract(wav, STFT, v=c)
        assert got.dtype == torch.float32 and got.shape == want.shape == (len(wav),)
        agree(got, want, 1e-4, f"denoised c={c}")


def test_wav2spec_return_linear_matches_jax():
    from neuralsvb_tpu.hparams import hparams_scope as jax_scope
    from neuralsvb_tpu.vocoders.hifigan import HifiGAN as JHifiGAN
    from neuralsvb_torch.hparams import hparams_scope
    from neuralsvb_torch.vocoders.base import BaseVocoder
    hp = dict(STFT, audio_sample_rate=SR, audio_num_mel_bins=80, fmin=80, fmax=7600,
              device="cpu")
    wav = _sung(0.5, 5)
    with hparams_scope(dict(hp)):
        tw, tm, ts = BaseVocoder.wav2spec(wav, return_linear=True)
        tw2, tm2 = BaseVocoder.wav2spec(wav)
    with jax_scope(dict(hp)):
        jw, jm, js = JHifiGAN.wav2spec(wav, return_linear=True)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tw2, tw)
    agree(tm, jm, 1e-5, "mel")
    assert ts.dtype == np.float32 and ts.shape == js.shape
    agree(ts, js, 1e-5, "linear")


@pytest.fixture(scope="module")
def flow():
    jm = jglow.ResidualCouplingBlock(channels=8, hidden_channels=16, kernel_size=3,
                                     dilation_rate=1, n_layers=2, n_flows=2, gin_channels=H)
    rng = np.random.RandomState(0)
    x = rng.randn(B, 12, 8).astype(np.float32)
    mask = (np.arange(12)[None] < np.asarray([[12], [9]]))[..., None].astype(np.float32)
    g = rng.randn(B, 12, H).astype(np.float32)
    params = _randomized(jm.init(jax.random.PRNGKey(0), x, mask, g)["params"], 1)
    tm = tglow.ResidualCouplingBlock(8, 16, 3, 1, 2, n_flows=2, gin_channels=H)
    tm.load_state_dict(j2t.glow_from_jax(params))
    return jm, params, tm, x * mask, mask, g


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_flow_matches_jax(flow, reverse):
    jm, params, tm, x, mask, g = flow
    jy, jld = jm.apply({"params": params}, x, mask, g, reverse=reverse)
    with torch.no_grad():
        ty, tld = tm(*(torch.tensor(a).transpose(1, 2) for a in (x, mask, g)), reverse=reverse)
        back, bld = tm(ty, torch.tensor(mask).transpose(1, 2), torch.tensor(g).transpose(1, 2),
                       reverse=not reverse)
    agree(ty.transpose(1, 2), jy, 1e-5, "flow out")
    agree(tld, jld, 1e-5, "logdet")
    agree(back.transpose(1, 2), x, 1e-5, "inverse")
    agree(bld, -np.asarray(jld), 1e-5, "inverse logdet")


@pytest.fixture(scope="module")
def prior_fvae():
    kw = dict(in_out_channels=80, hidden_channels=16, latent_size=LAT, kernel_size=5,
              enc_n_layers=2, dec_n_layers=2, gin_channels=H)
    glow = dict(use_prior_glow=True, glow_hidden=16, glow_kernel_size=3, glow_n_blocks=2)
    jm = jfvae.FVAE(**kw, global_latent=False, **glow)
    rng = np.random.RandomState(3)
    x = rng.randn(B, T, 80).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray([[T], [16]]))[..., None].astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = _np_tree(jm.init(rngs, x * mask, mask, g)["params"])
    params["prior_flow"] = _randomized(params["prior_flow"], 4, 0.2)
    tm = tfvae.FVAE(**kw, global_latent=False, **glow).eval()
    tm.load_state_dict(_fvae_sd(params))
    return jm, params, tm, x * mask, mask, g


def _fvae_sd(params):
    sd = j2t._SD()
    j2t._fvae(sd, "f", params, {})
    return {k[2:]: v for k, v in sd.items()}


def _t(a):
    return torch.tensor(a).transpose(1, 2)


def test_fvae_prior_flow_train_matches_jax(prior_fvae):
    jm, params, tm, x, mask, g = prior_fvae
    with jax_zero_noise():
        jr, jkl, jzp, jmq, jlq, jmask, jzq = jm.apply(
            {"params": params}, x, mask, g, rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = tm(_t(x), _t(mask), _t(g), zero_noise=True)
    agree(out["z_q"].transpose(1, 2), jzq, 1e-5, "z_q")
    agree(out["z_p"].transpose(1, 2), jzp, 1e-5, "z_p")
    agree(out["mel_out"].transpose(1, 2), jr, 1e-5, "mel_out")
    agree(out["kl"], jkl, 1e-5, "kl")


def test_fvae_prior_flow_infer_matches_jax(prior_fvae):
    jm, params, tm, x, mask, g = prior_fvae
    with jax_zero_noise():
        jr, jzp = jm.apply({"params": params}, None, mask, g, prior_mean=0.5, infer=True,
                           rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        tr, tzp = tm.infer(_t(g), _t(mask), zero_noise=True, prior_mean=0.5)
    assert float((tzp - 0.5).abs().max()) > 1e-3  # the reversed flow moved the sample
    agree(tzp.transpose(1, 2), jzp, 1e-5, "z_p")
    agree(tr.transpose(1, 2), jr, 1e-5, "x_recon")


@pytest.mark.parametrize("train", [False, True])
def test_tech_classifier_matches_jax(train):
    jm = jfvae.TechClassifier(LAT)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, LAT).astype(np.float32)
    style = rng.randn(3, 10, H).astype(np.float32)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), x, style))
    stats = _randomized(v["batch_stats"], 6, 0.2)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else a, stats)
    jo, mut = jm.apply({"params": v["params"], "batch_stats": stats}, x, style, train=train,
                       mutable=["batch_stats"])
    tm = tfvae.TechClassifier(LAT, H).train(train)
    tm.load_state_dict(j2t.tech_classifier_from_jax(v["params"], stats))
    with torch.no_grad():
        to = tm(_t(x), _t(style))
    agree(to, jo, 1e-5, "logits")
    new = j2t.tech_classifier_from_jax(v["params"], _np_tree(mut["batch_stats"]))
    for k, val in tm.state_dict().items():
        if "running" in k:
            agree(val, new[k].numpy(), 1e-5, k)


@pytest.mark.parametrize("reduction", ["sum", "none"])
def test_disc_reductions_match_jax(reduction):
    kw = dict(time_lengths=(16, 32), freq_length=80, hidden_size=8, norm_type="bn",
              reduction=reduction)
    jm = jdisc.Discriminator(**kw)
    rng = np.random.RandomState(7)
    mel = (rng.randn(2, 40, 80) - 2).astype(np.float32)
    v = _np_tree(jm.init({"params": jax.random.PRNGKey(0), "disc": jax.random.PRNGKey(1)},
                         mel, start_frames_wins=[3, 5]))
    jo = jm.apply(v, mel, start_frames_wins=[3, 5])
    tm = tdisc.Discriminator(**kw).eval()
    tm.load_state_dict(j2t.disc_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        to = tm(torch.tensor(mel), start_frames_wins=[3, 5])
    want = (2, 1) if reduction == "sum" else (2, 2 + 4)
    assert tuple(to["y"].shape) == want
    agree(to["y"], jo["y"], 1e-5, "validity")


def test_svbvae_prior_glow_fails_in_both():
    from neuralsvb_tpu.models.svb_vae import SVBVAE as JSVBVAE
    from neuralsvb_torch.models.svb_vae import SVBVAE as TSVBVAE
    jm = JSVBVAE(dict_size=20, hidden_size=32, latent_size=8, fvae_hidden=16,
                 fvae_enc_layers=2, fvae_dec_layers=2, asr_enc_layers=1, asr_dec_layers=1,
                 use_prior_glow=True)
    mels = np.zeros((2, 64, 80), np.float32)
    pitch = np.ones((2, 64), np.int32)
    with pytest.raises(TypeError, match="None"):
        jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, mels,
                mels, pitch, pitch, np.zeros((2, 256), np.float32), np.zeros((2, 64), np.int32),
                concurrent_ways=("a2a",))
    with pytest.raises(ValueError, match="svb_vae.py:84-90"):
        TSVBVAE(20, 32, latent_size=8, fvae_hidden=16, fvae_enc_layers=2, fvae_dec_layers=2,
                asr_enc_layers=1, use_prior_glow=True)
