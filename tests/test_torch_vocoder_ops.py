"""The vocoder-training modules of the PyTorch port against the JAX package:
the batched differentiable log-mel (values and a vector-Jacobian product,
1e-4 of scale in float32), the multi-period and multi-scale discriminators
(every output and feature map, 1e-5 of scale) with flax-initialized weights
carried over by ``mpd_from_jax``/``msd_from_jax``, the three GAN losses
(1e-5 relative) and the input gradient of the generator's adversarial and
feature losses at a zero-padded input (flax's zero biases keep the padded
stretch exactly 0, where ``jax.nn.leaky_relu``'s derivative is 1). Also the
generator's packed ResBlock weights after an in-place update."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralsvb_tpu.models import hifigan as jhifigan  # noqa: E402
from neuralsvb_tpu.ops.stft import log_mel_jax  # noqa: E402
from neuralsvb_torch.convert.jax2torch import mpd_from_jax, msd_from_jax  # noqa: E402
from neuralsvb_torch.models import hifigan as thifigan  # noqa: E402
from neuralsvb_torch.ops import fused_resblock as fr  # noqa: E402
from neuralsvb_torch.ops.stft import log_mel_batch  # noqa: E402

MEL = dict(sample_rate=22050, fft_size=512, hop_size=128, num_mels=80, fmin=50.0,
           fmax=11025.0)


def _scaled_err(got, want):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("win_size", [512, 384])
def test_log_mel_batch_matches_jax(win_size):
    rng = np.random.RandomState(0)
    wav = (0.1 * rng.randn(2, 3000)).astype(np.float32)
    wav[1, 1700:] = 0.0  # a zero-padded tail
    kw = dict(MEL, win_size=win_size)
    ct = rng.randn(2, 1 + 3000 // 128, 80).astype(np.float32)
    wt = torch.tensor(wav, requires_grad=True)
    got = log_mel_batch(wt, **kw)
    (g_t,) = torch.autograd.grad(got, wt, torch.tensor(ct))
    want, vjp = jax.vjp(lambda w: log_mel_jax(w, **kw), jnp.asarray(wav))
    (g_j,) = vjp(jnp.asarray(ct))
    assert got.shape == (2, 1 + 3000 // 128, 80)
    assert float((got - torch.tensor(np.asarray(want))).abs().max()) <= 1e-4
    assert _scaled_err(g_t, g_j) <= 1e-4


@pytest.fixture(scope="module")
def discs():
    """flax MPD / MSD at their init (zero biases) and the port's copies."""
    y = jnp.zeros((1, 1010))
    mpd, msd = jhifigan.MultiPeriodDiscriminator(), jhifigan.MultiScaleDiscriminator()
    p_mpd = mpd.init(jax.random.PRNGKey(2), y, y)["params"]
    p_msd = msd.init(jax.random.PRNGKey(3), y, y)["params"]
    t_mpd, t_msd = thifigan.MultiPeriodDiscriminator(), thifigan.MultiScaleDiscriminator()
    t_mpd.load_state_dict(mpd_from_jax(jax.device_get(p_mpd)))
    t_msd.load_state_dict(msd_from_jax(jax.device_get(p_msd)))
    return (mpd, p_mpd, t_mpd), (msd, p_msd, t_msd)


def _signals():
    """y, y_hat [2, 1010]: 1010 is not a multiple of 3, 7 or 11 (the period
    discriminators reflect-pad); y_hat's second row is zero past 600."""
    rng = np.random.RandomState(1)
    y = (0.3 * rng.randn(2, 1010)).astype(np.float32)
    y_hat = (0.3 * rng.randn(2, 1010)).astype(np.float32)
    y_hat[1, 600:] = 0.0
    return y, y_hat


def test_discriminators_match_flax(discs):
    y, y_hat = _signals()
    for (jm, params, tm), layout in zip(discs, ("nhwc", "nwc")):
        r_j, g_j, fr_j, fg_j = jm.apply({"params": params}, y, y_hat)
        with torch.no_grad():
            r_t, fr_t = tm(torch.tensor(y))
            g_t, fg_t = tm(torch.tensor(y_hat))
        for a, b in zip(r_t + g_t, r_j + g_j):
            assert _scaled_err(a, b) <= 1e-5
        for dt, dj in zip(fr_t + fg_t, fr_j + fg_j):
            assert len(dt) == len(dj)
            for a, b in zip(dt, dj):
                # flax feature maps are channels-last
                a = a.permute(0, 2, 3, 1) if layout == "nhwc" else a.transpose(1, 2)
                assert _scaled_err(a, b) <= 1e-5

        # the three losses, each side on its own outputs
        pairs = [(thifigan.generator_loss(g_t), jhifigan.generator_loss(g_j)),
                 (thifigan.feature_loss(fr_t, fg_t), jhifigan.feature_loss(fr_j, fg_j))]
        pairs += list(zip(thifigan.discriminator_loss(r_t, g_t),
                          jhifigan.discriminator_loss(r_j, g_j)))
        for a, b in pairs:
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_adversarial_input_gradient_at_zero_padding(discs):
    """d(generator + feature loss)/d y_hat through both discriminators; the
    zero-padded stretch of y_hat keeps every conv output there at exactly 0."""
    y, y_hat = _signals()
    (jmpd, pmpd, tmpd), (jmsd, pmsd, tmsd) = discs

    def jax_loss(yh):
        total = 0.0
        for jm, p in ((jmpd, pmpd), (jmsd, pmsd)):
            _, g, f_r, f_g = jm.apply({"params": p}, y, yh)
            total = total + jhifigan.generator_loss(g) + jhifigan.feature_loss(f_r, f_g)
        return total

    want = jax.grad(jax_loss)(jnp.asarray(y_hat))
    yh = torch.tensor(y_hat, requires_grad=True)
    total = 0.0
    for tm in (tmpd, tmsd):
        with torch.no_grad():
            _, f_r = tm(torch.tensor(y))
        g, f_g = tm(yh)
        total = total + thifigan.generator_loss(g) + thifigan.feature_loss(f_r, f_g)
    (got,) = torch.autograd.grad(total, yh)
    assert float(np.abs(np.asarray(want)[1, 700:]).max()) > 0  # the padded stretch counts
    assert _scaled_err(got, want) <= 1e-4


GEN = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
           resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)),
           use_pitch_embed=False)


@pytest.mark.parametrize("trainable", [False, True])
def test_packed_weights_follow_in_place_updates(trainable):
    """Without gradients the generator reuses its packed ResBlock weights
    only while they are unchanged: an in-place write (an optimizer step, or
    a frozen model's weights set by hand) makes it pack again. The output
    then equals a fresh generator's with the same weights, which packs the
    new weights through the plain cluster."""
    torch.manual_seed(0)
    gen = thifigan.HifiGanGenerator(**GEN).requires_grad_(trainable)
    mel = torch.randn(1, 10, 80)
    with torch.no_grad():
        before = gen(mel)
    if trainable:
        opt = torch.optim.Adam(gen.resblocks.parameters(), lr=1e-2)
        gen(mel).square().mean().backward()
        opt.step()
    else:
        with torch.no_grad():
            gen.resblocks[1].convs1[0].weight.mul_(1.5)
    fresh = thifigan.HifiGanGenerator(**GEN)
    fresh.load_state_dict(gen.state_dict())
    with torch.no_grad():
        after, want = gen(mel), fresh(mel)
        cluster = gen._stage_weights(torch.float32)
        x = torch.randn(1, 16, 40)
        torch.testing.assert_close(fr.resblock_cluster_plain(x, cluster[0], gen.spec),
                                   fr.resblock_cluster_plain(x, fresh._pack(torch.float32)[0],
                                                             gen.spec), rtol=0, atol=0)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, want, rtol=0, atol=0)


def test_smoke_times_the_vocoder_training_shapes(monkeypatch):
    """``chip_smoke.py`` holds the bf16 kernel at the shapes the vocoder's
    training path launches: ``max_sentences`` crops of ``max_samples``, stage
    i at C = 512 / 2^(i+1) channels and the crop's frames times the rates so
    far; its timed steps take the recipe's batch."""
    import chip_smoke
    from neuralsvb_torch.hparams import load_config_recursive
    monkeypatch.chdir(chip_smoke.REPO)
    cfg = load_config_recursive("egs/datasets/audio/PopBuTFy/hifigan_nsf_torch.yaml")
    T, shapes = cfg["max_samples"] // cfg["hop_size"], []
    for i, r in enumerate(cfg["upsample_rates"]):
        T *= r
        shapes.append((cfg["max_sentences"], cfg["upsample_initial_channel"] // 2 ** (i + 1), T))
    assert tuple(shapes) == chip_smoke.TRAIN_SHAPES
    assert chip_smoke.VOC_BATCH == cfg["max_sentences"]
