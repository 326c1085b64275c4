"""MleSVBVAE and its parts on the PyTorch port vs the JAX package, at tiny
widths (hidden 32, latent 8, FVAE 16 wide with 2+2 WN layers, a one-layer
ASR conformer) and zero noise, on padded B=2 batches of unequal lengths.
Tolerances are the JAX package's (tests/test_parity_reference.py): 1e-4 for
modules, 5e-4 for ``mel_out``, 1e-3 for ``mle``."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_support import (agree, flax_load, jax_zero_noise,  # noqa: E402
                                      sd_numpy, seeded)

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.models import asr as jasr  # noqa: E402
from neuralsvb_tpu.models import conformer as jconf  # noqa: E402
from neuralsvb_tpu.models import fvae as jfvae  # noqa: E402
from neuralsvb_tpu.models import svb_vae as jsvb  # noqa: E402
from neuralsvb_tpu.models import wn as jwn  # noqa: E402
from neuralsvb_torch.models import asr as tasr  # noqa: E402
from neuralsvb_torch.models import conformer as tconf  # noqa: E402
from neuralsvb_torch.models import fvae as tfvae  # noqa: E402
from neuralsvb_torch.models import svb_vae as tsvb  # noqa: E402
from neuralsvb_torch.models import wn as twn  # noqa: E402

H, LAT, FH = 32, 8, 16
B, T = 2, 64
LENS = (64, 44)  # the second example is padded


def _mask(T_, lens):
    return (np.arange(T_)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def _prefixed(sd, prefix="m"):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _t(x):
    return torch.tensor(x)


def _bct(x):
    return torch.tensor(x).transpose(1, 2)


def test_conformer_padded_batch():
    """Exact-length rel-pos semantics on a padded batch."""
    rng = np.random.RandomState(0)
    T2 = 40
    x = rng.randn(B, T2, H).astype(np.float32) * _mask(T2, (40, 27))[:, :, None]
    tm = seeded(lambda: tconf.ConformerLayers(H, 2, kernel_size=31, num_heads=4,
                                              use_last_norm=False))
    with torch.no_grad():
        yt = tm(_t(x))
    params, stats = t2j.convert_conformer(_prefixed(sd_numpy(tm)), "m", 2)
    jm = jconf.ConformerLayers(H, 2, kernel_size=31, num_heads=4,
                               use_last_norm=False)
    v = flax_load(jm, (x,), {}, params, stats)
    agree(yt, jm.apply(v, x), 1e-4, "ConformerLayers")


def test_vcasr_padded_batch():
    rng = np.random.RandomState(1)
    mel = (rng.randn(B, T, 80).astype(np.float32) - 2) * _mask(T, LENS)[:, :, None]
    tm = seeded(lambda: tasr.VCASR(20, H, 1, (2, 1, 1), asr_last_norm=False), 1)
    with torch.no_grad():
        yt = tm(_bct(mel))["h_content"].transpose(1, 2)
    params, stats = t2j.convert_vcasr(_prefixed(sd_numpy(tm)), "m", 1, 1)
    jm = jasr.VCASR(20, H, 1, 1, (2, 1, 1), asr_last_norm=False)
    v = flax_load(jm, (mel,), {}, params, stats)
    agree(yt, jm.apply(v, mel)["h_content"], 1e-4, "VCASR h_content")


def test_wn():
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, FH).astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    mask = _mask(T, LENS)[:, :, None]
    tm = seeded(lambda: twn.WN(FH, 5, 2, 3, H), 2)
    with torch.no_grad():
        yt = tm(_bct(x), _bct(mask), _bct(g)).transpose(1, 2)
    params = t2j.convert_wn(_prefixed(sd_numpy(tm)), "m", 3)
    jm = jwn.WN(FH, 5, 2, 3, H)
    v = flax_load(jm, (x, mask, g), {}, params)
    agree(yt, jm.apply(v, x, mask, g), 1e-4, "WN")


def _fvae_pair():
    tm = seeded(lambda: tfvae.FVAE(80, FH, LAT, 5, 2, 2, H, 4), 3)
    params, stats = t2j.convert_global_fvae(_prefixed(sd_numpy(tm)), "m", 2, 2)
    jm = jfvae.FVAE(80, FH, LAT, 5, 2, 2, H, strides=(4,), global_latent=True)
    return tm, jm, params, stats


def test_global_fvae_padded_batch():
    rng = np.random.RandomState(3)
    mask = _mask(T, LENS)[:, :, None]
    x = (rng.randn(B, T, 80).astype(np.float32) - 2) * mask
    g = rng.randn(B, T, H).astype(np.float32) * mask
    tm, jm, params, stats = _fvae_pair()
    with torch.no_grad():
        rt = tm(_bct(x), _bct(mask), _bct(g), zero_noise=True)
    v = flax_load(jm, (x, mask, g), {}, params, stats)
    with jax_zero_noise():
        recon, kl, _, m_q, logs_q, _, z_q = jm.apply(
            v, x, mask, g, rngs={"noise": jax.random.PRNGKey(0)})
    agree(rt["m_q"].transpose(1, 2), m_q, 1e-4, "m_q")
    agree(rt["logs_q"].transpose(1, 2), logs_q, 1e-4, "logs_q")
    agree(rt["z_q"].transpose(1, 2), z_q, 1e-4, "z_q")
    agree(rt["kl"], kl, 1e-4, "kl")
    agree(rt["mel_out"].transpose(1, 2), recon, 5e-4, "mel_out")


def test_global_latent_map():
    rng = np.random.RandomState(4)
    z = rng.randn(B, 1, LAT).astype(np.float32)
    style = np.repeat(rng.randn(B, 1, H).astype(np.float32), 10, axis=1)
    tm = seeded(lambda: tfvae.GlobalLatentMap(LAT, H), 4)
    with torch.no_grad():
        yt = tm(_bct(z), _bct(style)).transpose(1, 2)
    params, stats = t2j.convert_global_latent_map(_prefixed(sd_numpy(tm)), "m")
    jm = jfvae.GlobalLatentMap(LAT)
    v = flax_load(jm, (z, style), {}, params, stats)
    agree(yt, jm.apply(v, z, style), 1e-4, "GlobalLatentMap")


TINY = dict(hidden_size=H, latent_size=LAT, fvae_hidden=FH, fvae_kernel=5,
            fvae_enc_layers=2, fvae_dec_layers=2, mel_strides=(2, 1, 1),
            asr_enc_layers=1, asr_last_norm=False)


def svbvae_inputs(seed=5, lens_a=LENS, lens_p=(60, 52), T_=T):
    rng = np.random.RandomState(seed)
    ma, mp = _mask(T_, lens_a), _mask(T_, lens_p)
    mel_a = (rng.randn(B, T_, 80).astype(np.float32) - 2) * ma[:, :, None]
    mel_p = (rng.randn(B, T_, 80).astype(np.float32) - 2) * mp[:, :, None]
    pitch_a = (rng.randint(1, 255, (B, T_)) * ma).astype(np.int64)
    pitch_p = (rng.randint(1, 255, (B, T_)) * mp).astype(np.int64)
    spk = rng.randn(B, 256).astype(np.float32)
    align = np.stack([np.sort(rng.randint(0, la, T_)) for la in lens_a]) * mp
    return mel_a, mel_p, pitch_a, pitch_p, spk, align.astype(np.int64)


def jax_svbvae(tm, dict_size=20):
    """The JAX MleSVBVAE holding ``tm``'s weights (via torch2jax)."""
    params, stats = t2j.convert_svbvae_mle_sd(sd_numpy(tm), 2, 2, 1, 1)
    jm = jsvb.SVBVAE(dict_size=dict_size, hidden_size=H, latent_size=LAT,
                     fvae_hidden=FH, fvae_kernel=5, fvae_enc_layers=2,
                     fvae_dec_layers=2, mel_strides=(2, 1, 1), asr_enc_layers=1,
                     asr_dec_layers=1, variant="mle")
    return jm, params, stats


def test_svbvae_mle_three_ways():
    inputs = svbvae_inputs()
    tm = seeded(lambda: tsvb.SVBVAE(20, **TINY), 5)
    with torch.no_grad():
        rt = tm(*[_t(a) for a in inputs], zero_noise=True)
    jm, params, stats = jax_svbvae(tm)
    jin = tuple(a.astype(np.int32) if a.dtype == np.int64 else a for a in inputs)
    kw = dict(concurrent_ways=("a2a", "p2p", "a2p"))
    v = flax_load(jm, jin, kw, params, stats)
    with jax_zero_noise():
        rj = jm.apply(v, *jin, rngs={"noise": jax.random.PRNGKey(3)}, **kw)
    for way in ("a2a", "p2p"):
        agree(rt[way]["m_q"].transpose(1, 2), rj[way]["m_q"], 1e-4, f"{way} m_q")
        agree(rt[way]["logs_q"].transpose(1, 2), rj[way]["logs_q"], 1e-4,
              f"{way} logs_q")
        agree(rt[way]["mel_out"], rj[way]["mel_out"], 5e-4, f"{way} mel_out")
    agree(rt["a2p"]["mle"], rj["a2p"]["mle"], 1e-3, "a2p mle")
    agree(rt["a2p"]["mel_out"], rj["a2p"]["mel_out"], 5e-4, "a2p mel_out")
