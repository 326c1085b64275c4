"""Parallel WaveGAN on the PyTorch port against the JAX package, at the
widths of the JAX package's own PWG task test (``tests/test_tasks2.py``: 4
layers in 2 stacks, residual/gate/skip 8/16/8, upsample scales 4,4,8 for
hop 128). Flax initializes each JAX model; every leaf then gets seeded
noise (flax's zero biases and constant upsample kernels would hide a
swapped layout), and ``pwg_from_jax``/``pwg_disc_from_jax`` carry the
weights into the port. The noise ``z`` is injected on both sides.

Tolerances: the generator's wav 1e-4 (the JAX package's PWG gate,
``tests/test_parity_reference.py``), also through ``PWG.spec2wav`` from a
port checkpoint and from an official one (weight norm, feature scaler);
the discriminator 1e-5; the multi-resolution STFT loss 1e-5 relative;
``wav2mfcc`` (float64 on both sides) 1e-6."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree  # noqa: E402

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.models import pwg as jpwg  # noqa: E402
from neuralsvb_tpu.models import stft_loss as jstft  # noqa: E402
from neuralsvb_torch.convert.jax2torch import pwg_disc_from_jax, pwg_from_jax  # noqa: E402
from neuralsvb_torch.models import pwg as tpwg  # noqa: E402
from neuralsvb_torch.models import stft_loss as tstft  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
            upsample_scales=(4, 4, 8))
HOP = 128


def noisy(params, rng, scale=0.1):
    """Every leaf of a flax tree plus seeded Gaussian noise (numpy leaves)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(np.float32), params)


def jax_generator(ctx=2, pitch=False, seed=0, T=8):
    jm = jpwg.ParallelWaveGANGenerator(aux_context_window=ctx, use_pitch_embed=pitch, **TINY)
    z = np.zeros((1, T * HOP, 1), np.float32)
    c = np.zeros((1, T + 2 * ctx, 80), np.float32)
    p = np.zeros((1, T), np.int32) if pitch else None
    params = jm.init(jax.random.PRNGKey(seed), z, c, p)["params"]
    return jm, noisy(params, np.random.RandomState(seed))


def port_generator(params, ctx=2, pitch=False):
    tm = tpwg.ParallelWaveGANGenerator(aux_context_window=ctx, use_pitch_embed=pitch, **TINY)
    tm.load_state_dict(pwg_from_jax(params))  # strict: every name present
    return tm.eval()


@pytest.mark.parametrize("pitch", [False, True])
@pytest.mark.parametrize("ctx", [0, 2])
def test_generator_matches_jax(ctx, pitch):
    jm, params = jax_generator(ctx, pitch, seed=ctx + 2 * pitch)
    tm = port_generator(params, ctx, pitch)
    rng = np.random.RandomState(10 + ctx)
    T = 12
    z = rng.randn(2, T * HOP, 1).astype(np.float32)
    c = (rng.randn(2, T + 2 * ctx, 80) - 2).astype(np.float32)
    p = rng.randint(0, 256, (2, T)) if pitch else None  # 0: the padding id
    with torch.no_grad():
        wav_t = tm(torch.tensor(z).transpose(1, 2), torch.tensor(c).transpose(1, 2),
                   None if p is None else torch.tensor(p))
    wav_j = jm.apply({"params": params}, z, c, None if p is None else p.astype(np.int32))
    assert wav_t.shape == (2, T * HOP)
    agree(wav_t, wav_j, 1e-4, f"PWG wav (ctx {ctx}, pitch {pitch})")


def test_discriminator_matches_jax():
    jd = jpwg.ParallelWaveGANDiscriminator()
    rng = np.random.RandomState(3)
    x = (0.3 * rng.randn(2, 1500)).astype(np.float32)
    params = noisy(jd.init(jax.random.PRNGKey(1), x)["params"], rng, 0.05)
    td = tpwg.ParallelWaveGANDiscriminator()
    td.load_state_dict(pwg_disc_from_jax(params))
    assert len(td.conv_layers) == 19  # 9 convs + 9 leaky ReLUs + the last conv
    with torch.no_grad():
        out = td(torch.tensor(x))
    agree(out, jd.apply({"params": params}, x), 1e-5, "PWG discriminator")


@pytest.mark.parametrize("resolutions", [jstft.DEFAULT_RESOLUTIONS,
                                         ((512, 64, 256), (256, 32, 100), (128, 16, 128))],
                         ids=["default", "win_lt_fft"])
def test_multi_resolution_stft_loss_matches_jax(resolutions):
    rng = np.random.RandomState(4)
    y = (0.3 * rng.randn(2, 4100)).astype(np.float32)
    y_hat = (y + 0.2 * rng.randn(2, 4100)).astype(np.float32)
    got = tstft.multi_resolution_stft_loss(torch.tensor(y_hat), torch.tensor(y), resolutions)
    want = jstft.multi_resolution_stft_loss(jnp.asarray(y_hat), jnp.asarray(y), resolutions)
    for name, g, w in zip(("sc", "mag"), got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, err_msg=name)
    for fft, hop, win in resolutions:  # frames and window placement, win < fft too
        mag_t = tstft.stft_magnitude(torch.tensor(y), fft, hop, win)
        agree(mag_t.transpose(1, 2), jstft.stft_magnitude(jnp.asarray(y), fft, hop, win),
              1e-4, f"magnitude {fft}/{hop}/{win}")


def _save_port_checkpoint(directory, params, ctx):
    """A PWG checkpoint directory as the port's trainer leaves it: the
    generator under ``state_dict.model_gen`` and a ``config.yaml`` whose
    two key sets (the task's and the vocoder loader's) agree."""
    os.makedirs(directory, exist_ok=True)
    sd = pwg_from_jax(params)
    path = os.path.join(directory, "model_ckpt_steps_3.ckpt")
    torch.save({"state_dict": {"model_gen": sd}}, path)
    gp = dict(TINY, upsample_scales=list(TINY["upsample_scales"]), aux_context_window=ctx,
              upsample_params={"upsample_scales": list(TINY["upsample_scales"])})
    with open(os.path.join(directory, "config.yaml"), "w") as f:
        yaml.safe_dump({"generator_params": gp, "aux_context_window": ctx}, f)
    return path, sd


def test_pwg_round_trip(tmp_path):
    """JAX params -> ``pwg_from_jax`` -> a torch checkpoint -> the JAX
    package's ``convert_pwg``: the same tree, leaf for leaf."""
    jm, params = jax_generator(ctx=2)
    path, sd = _save_port_checkpoint(str(tmp_path), params, 2)
    back = t2j.convert_pwg(path, jm)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for k, v in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), v, err_msg=str(k))
    assert set(sd) == set(tpwg.ParallelWaveGANGenerator(**TINY).state_dict())
    jd = jpwg.ParallelWaveGANDiscriminator()
    dparams = jd.init(jax.random.PRNGKey(2), np.zeros((1, 256), np.float32))["params"]
    assert set(pwg_disc_from_jax(dparams)) == set(
        tpwg.ParallelWaveGANDiscriminator().state_dict())


def test_spec2wav_matches_jax(tmp_path, monkeypatch):
    """Both ``PWG`` vocoders load one checkpoint directory; through the
    registry, with the same injected z, the port's wav equals the JAX one."""
    from neuralsvb_tpu.vocoders.pwg import PWG as JPWG
    from neuralsvb_torch.vocoders.base import get_vocoder_cls
    ctx = 2
    _, params = jax_generator(ctx)
    _save_port_checkpoint(str(tmp_path), params, ctx)
    hp = {"vocoder": "pwg", "vocoder_ckpt": str(tmp_path), "device": "cpu"}
    rng = np.random.RandomState(5)
    T = 40  # pads to the 128 bucket
    mel = (rng.randn(T, 80) - 2).astype(np.float32)
    z = rng.randn(1, 1, 128 * HOP).astype(np.float32)
    voc = get_vocoder_cls(hp)(dict(hp))
    assert type(voc).__name__ == "PWG"
    wav_t = voc.spec2wav(mel, z=torch.tensor(z))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z).reshape(shape))
    wav_j = JPWG(dict(hp)).spec2wav(mel)
    assert wav_t.shape == (T * HOP,)
    agree(wav_t, wav_j, 1e-4, "spec2wav")
    drawn = voc.spec2wav(mel)  # from the vocoder's own generator
    assert drawn.shape == (T * HOP,) and torch.isfinite(drawn).all()


def test_two_readers_disagree_on_the_recipe(tmp_path):
    """The JAX package's ``PWGTask`` and ``load_pwg`` read different keys:
    on ``pwg.yaml`` the task builds ``conv_in`` with k = 1
    (``aux_context_window: 0`` of vocoder/base.yaml), the loader with
    k = 5 (``generator_params.aux_context_window`` is absent, so 2). The
    port reads each key as its JAX counterpart does, so a checkpoint that
    the recipe trains does not load into the recipe's vocoder."""
    from neuralsvb_tpu.vocoders.pwg import load_pwg as jax_load_pwg
    from neuralsvb_torch.hparams import hparams_scope, load_config_recursive
    from neuralsvb_torch.tasks.vocoder_task import PWGTask
    from neuralsvb_torch.vocoders.pwg import load_pwg
    cfg = load_config_recursive(os.path.join(REPO, "egs/egs_bases/tts/vocoder/pwg.yaml"))
    assert cfg["aux_context_window"] == 0
    jm, _, _, _ = jax_load_pwg("", dict(cfg))
    assert jm.aux_context_window == 2 and tuple(jm.upsample_scales) == (4, 4, 4, 4)
    with hparams_scope(dict(cfg, device="cpu", generator_params=dict(
            cfg["generator_params"], layers=2, stacks=1))):
        task = PWGTask()
        task.build_model()
    assert task.model.upsample_net.conv_in.weight.shape[-1] == 1
    served, _, _, _ = load_pwg("", dict(cfg), torch.device("cpu"))
    assert served.upsample_net.conv_in.weight.shape[-1] == 5
    torch.save({"state_dict": {"model_gen": task.model.state_dict()}},
               str(tmp_path / "model_ckpt_steps_1.ckpt"))
    small = dict(cfg, generator_params=dict(cfg["generator_params"], layers=2, stacks=1))
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_pwg(str(tmp_path), small, torch.device("cpu"))


def _weight_normed(sd):
    """``sd`` with every conv weight split into the reference's
    ``weight_g``/``weight_v`` (folding gives the weight back)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 3 and "conv_in" not in k:
            base = k[: -len("weight")]
            out[base + "weight_v"] = 2 * v
            out[base + "weight_g"] = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("stats", ["npy", "h5"])
def test_official_checkpoint_matches_jax(tmp_path, monkeypatch, stats):
    """An official ParallelWaveGAN directory: a weight-normed
    ``{"model": {"generator": ...}}`` pickle and a feature scaler in
    ``stats.npy`` or ``stats.h5``. Both vocoders scale the mel and vocode
    alike; without ``h5py`` the port raises on ``stats.h5``."""
    from neuralsvb_tpu.vocoders.pwg import PWG as JPWG
    from neuralsvb_torch.vocoders.pwg import PWG
    ctx = 2
    _, params = jax_generator(ctx, seed=7)
    torch.save({"model": {"generator": _weight_normed(pwg_from_jax(params))}, "steps": 4},
               str(tmp_path / "checkpoint-4steps.pkl"))
    rng = np.random.RandomState(8)
    mean, scale = rng.randn(80).astype(np.float32), rng.uniform(0.5, 2, 80).astype(np.float32)
    if stats == "npy":
        np.save(str(tmp_path / "stats.npy"), np.stack([mean, scale]))
    else:
        h5py = pytest.importorskip("h5py")
        with h5py.File(str(tmp_path / "stats.h5"), "w") as f:
            f["mean"], f["scale"] = mean, scale
    gp = dict(TINY, upsample_scales=list(TINY["upsample_scales"]), aux_context_window=ctx,
              upsample_params={"upsample_scales": list(TINY["upsample_scales"])})
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump({"generator_params": gp, "format": "hdf5" if stats == "h5" else "npy"}, f)
    hp = {"vocoder_ckpt": str(tmp_path), "device": "cpu"}
    T = 30
    mel = (rng.randn(T, 80) - 2).astype(np.float32)
    z = rng.randn(1, 1, 128 * HOP).astype(np.float32)
    voc = PWG(dict(hp))
    assert voc.scaler is not None
    wav_t = voc.spec2wav(mel, z=torch.tensor(z))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(z).reshape(shape))
        wav_j = JPWG(dict(hp)).spec2wav(mel)
    agree(wav_t, wav_j, 1e-4, f"official checkpoint, stats.{stats}")
    if stats == "h5":
        monkeypatch.setitem(sys.modules, "h5py", None)
        with pytest.raises(RuntimeError, match="h5py"):
            PWG(dict(hp))


def test_wav2mfcc_matches_jax(tmp_path):
    from neuralsvb_tpu.hparams import hparams_scope as jax_scope
    from neuralsvb_tpu.vocoders.pwg import PWG as JPWG
    from neuralsvb_torch.hparams import hparams_scope
    from neuralsvb_torch.ops.audio import save_wav
    from neuralsvb_torch.vocoders.pwg import PWG
    t = np.arange(11025) / 22050
    wav = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.RandomState(9).randn(
        len(t))).astype(np.float32)
    fn = str(tmp_path / "a.wav")
    save_wav(wav, fn, 22050)
    hp = dict(audio_sample_rate=22050, fft_size=512, hop_size=HOP, win_size=512)
    with hparams_scope(dict(hp, device="cpu")):
        got = PWG.wav2mfcc(fn)
    with jax_scope(dict(hp)):
        want = JPWG.wav2mfcc(fn)
    assert got.shape == want.shape == (1 + len(wav) // HOP, 39)
    np.testing.assert_allclose(got, want, atol=1e-6)
