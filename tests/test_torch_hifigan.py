"""HiFiGAN-NSF on the PyTorch port vs the JAX package, at zero noise:
the NSF source, ResBlock1/ResBlock2, the whole generator (against JAX with
the ResBlock cluster unfused and fused) and ``spec2wav`` with its bucket
padding. Tolerance 1e-4, as the JAX package's own parity tests use."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_support import (agree, flax_load, jax_zero_noise,  # noqa: E402
                                      sd_numpy, seeded)

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.models import hifigan as jhifigan  # noqa: E402
from neuralsvb_tpu.models import nsf as jnsf  # noqa: E402
from neuralsvb_torch.models import hifigan as thifigan  # noqa: E402
from neuralsvb_torch.models import nsf as tnsf  # noqa: E402

SR = 22050


def _f0(B, L, seed=1):
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(100.0, 600.0, (B, L)).astype(np.float32)
    f0[:, L // 3: L // 2] = 0.0  # an unvoiced stretch
    return f0


def test_source_module_parity():
    B, L, H = 2, 1500, 8
    f0 = _f0(B, L)[:, :, None]
    tm = seeded(lambda: tnsf.SourceModuleHnNSF(SR, H))
    f0_t = torch.tensor(f0).transpose(1, 2)  # the port's [B, 1, L]
    with torch.no_grad():
        sines_t, uv_t, _ = tm.l_sin_gen(f0_t, zero_noise=True)
        merge_t, _, _ = tm(f0_t, zero_noise=True)
    sd = sd_numpy(tm)
    params = {"l_linear": t2j.linear_to_flax(sd["l_linear.weight"],
                                             sd["l_linear.bias"])}
    jm = jnsf.SourceModuleHnNSF(SR, H)
    with jax_zero_noise():
        sines_j, uv_j, _ = jnsf.SineGen(SR, H).apply(
            {}, f0, rngs={"noise": jax.random.PRNGKey(0)})
        merge_j, _, _ = jm.apply({"params": params}, f0,
                                 rngs={"noise": jax.random.PRNGKey(0)})
    agree(uv_t.transpose(1, 2), uv_j, 0.0, "uv")
    agree(sines_t.transpose(1, 2), sines_j, 1e-4, "sine waves")
    agree(merge_t.transpose(1, 2), merge_j, 1e-4, "sine merge")


def test_sinegen_injected_noise():
    """rand_ini / noise tensors replace the draws; a generator draws them."""
    f0 = torch.tensor(_f0(1, 400))[:, None]
    sg = tnsf.SineGen(SR, 2)
    ini = torch.full((1, 3), 0.25)
    a, _, _ = sg(f0, rand_ini=ini, noise=torch.zeros(1, 3, 400))
    b, _, _ = sg(f0, zero_noise=True)
    assert not torch.allclose(a[:, 1:], b[:, 1:])  # overtone phase moved
    torch.testing.assert_close(a[:, 0], b[:, 0])   # fundamental did not
    with pytest.raises(ValueError):
        sg(f0)  # neither a generator nor zero_noise
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    torch.testing.assert_close(sg(f0, generator=g1)[0], sg(f0, generator=g2)[0])


@pytest.mark.parametrize("kind,k,dil", [("1", 3, (1, 3, 5)), ("1", 11, (1, 3, 5)),
                                        ("2", 3, (1, 3))])
def test_resblock_parity(kind, k, dil):
    C, T = 32, 90
    x = np.random.RandomState(2).randn(2, T, C).astype(np.float32)
    cls_t = thifigan.ResBlock1 if kind == "1" else thifigan.ResBlock2
    cls_j = jhifigan.ResBlock1 if kind == "1" else jhifigan.ResBlock2
    tm = seeded(lambda: cls_t(C, k, dil))
    with torch.no_grad():
        yt = tm(torch.tensor(x).transpose(1, 2)).transpose(1, 2)
    sd = sd_numpy(tm)
    if kind == "1":
        params = {f"conv{n}_{j}": t2j._conv(sd, f"convs{n}.{j}")
                  for n in (1, 2) for j in range(len(dil))}
    else:
        params = {f"conv_{j}": t2j._conv(sd, f"convs.{j}") for j in range(len(dil))}
    yj = cls_j(C, k, dil).apply({"params": params}, x)
    agree(yt, yj, 1e-4, f"ResBlock{kind} k={k}")


GEN = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=128, resblock="1",
           resblock_kernel_sizes=(3, 7, 11),
           resblock_dilation_sizes=((1, 3, 5),) * 3, use_pitch_embed=True,
           audio_sample_rate=SR)


def _generator_and_params(tmp_path):
    tm = seeded(lambda: thifigan.HifiGanGenerator(**GEN))
    path = str(tmp_path / "model_ckpt_steps_0.ckpt")
    torch.save({"state_dict": {"model_gen": tm.state_dict()}}, path)
    return tm, path


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_generator_parity(tmp_path, fuse):
    """The port's generator (plain ResBlock cluster on the CPU) against the
    JAX generator with the cluster unfused and fused (Pallas, interpret)."""
    tm, path = _generator_and_params(tmp_path)
    jm = jhifigan.HifiGanGenerator(**GEN, fuse_resblocks=fuse)
    params = t2j.convert_hifigan(path, jm)
    rng = np.random.RandomState(1)
    Tm = 24
    mel = (rng.randn(2, Tm, 80) - 2).astype(np.float32)
    f0 = _f0(2, Tm)
    with torch.no_grad():
        wav_t = tm(torch.tensor(mel), torch.tensor(f0), zero_noise=True)
    v = flax_load(jm, (mel, f0), {}, params)
    with jax_zero_noise():
        wav_j = jm.apply(v, mel, f0, rngs={"noise": jax.random.PRNGKey(3)})
    assert wav_t.shape == (2, Tm * 16)
    agree(wav_t, wav_j, 1e-4, f"generator wav (JAX fuse={fuse})")


def test_spec2wav_parity(tmp_path):
    """Both vocoder wrappers load one checkpoint directory (config.yaml +
    torch checkpoint) and pad to the same bucket; with ``vocoder_denoise_c``
    both denoise by spectral subtraction (an STFT of 64 points at the hop
    of 16), the port on its device, within the same 1e-4."""
    import yaml

    from neuralsvb_tpu.vocoders.hifigan import HifiGAN as JHifiGAN
    from neuralsvb_torch.vocoders.hifigan import HifiGAN as THifiGAN
    _generator_and_params(tmp_path)
    cfg = {k: list(v) if isinstance(v, tuple) else v for k, v in GEN.items()}
    cfg["resblock_dilation_sizes"] = [list(d) for d in GEN["resblock_dilation_sizes"]]
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    hp = {"vocoder_ckpt": str(tmp_path), "audio_sample_rate": SR,
          "audio_num_mel_bins": 80, "vocoder_denoise_c": 0.0, "device": "cpu"}
    rng = np.random.RandomState(4)
    mel = (rng.randn(40, 80) - 2).astype(np.float32)  # pads to bucket 128
    f0 = _f0(1, 40)[0]
    wav_t = THifiGAN(dict(hp)).spec2wav(mel, f0=f0, zero_noise=True)
    with jax_zero_noise():
        wav_j = JHifiGAN(dict(hp)).spec2wav(mel, f0=f0)
    assert wav_t.shape == (40 * 16,)
    agree(wav_t, wav_j, 1e-4, "spec2wav")
    den = dict(hp, vocoder_denoise_c=0.01, fft_size=64, hop_size=16, win_size=64)
    den_t = THifiGAN(dict(den)).spec2wav(mel, f0=f0, zero_noise=True)
    with jax_zero_noise():
        den_j = JHifiGAN(dict(den)).spec2wav(mel, f0=f0)
    assert den_t.shape == (40 * 16,) and den_t.dtype == torch.float32
    agree(den_t, den_j, 1e-4, "denoised spec2wav")
    assert float((den_t - wav_t).abs().max()) > 1e-3


def test_vocoder_needs_device_and_reference_checkpoint(tmp_path):
    """No ``device`` hparam raises rather than choosing one; a checkpoint
    without ``state_dict.model_gen`` raises rather than loading elsewhere."""
    from neuralsvb_torch.vocoders.hifigan import HifiGAN as THifiGAN
    tm = seeded(lambda: thifigan.HifiGanGenerator(**GEN))
    torch.save({"state_dict": {"model": tm.state_dict()}},
               str(tmp_path / "model_ckpt_steps_0.ckpt"))
    hp = {"vocoder_ckpt": str(tmp_path), "audio_sample_rate": SR,
          "audio_num_mel_bins": 80, "vocoder_denoise_c": 0.0, **GEN}
    with pytest.raises(ValueError, match="device"):
        THifiGAN(dict(hp))
    with pytest.raises(KeyError, match="model_gen"):
        THifiGAN(dict(hp, device="cpu"))


def test_smoke_times_the_main_paths_cluster_shapes(monkeypatch):
    """``chip_smoke.py`` times the cluster kernels at the shapes its main
    path runs: every smoke utterance pads to one vocoder bucket, and stage i
    of the flagship vocoder sees C = 512 / 2^(i+1) channels at that bucket
    times the rates so far."""
    import chip_smoke
    from neuralsvb_torch.vocoders.hifigan import pick_bucket
    monkeypatch.chdir(chip_smoke.REPO)
    voc = chip_smoke.vocoder_keys()
    (bucket,) = {pick_bucket(t) for t in chip_smoke.UTT_FRAMES}
    T, shapes = bucket, []
    for i, r in enumerate(voc["upsample_rates"]):
        T *= r
        shapes.append((1, voc["upsample_initial_channel"] // 2 ** (i + 1), T))
    assert bucket == 2048 and tuple(shapes) == chip_smoke.BUCKET_SHAPES
