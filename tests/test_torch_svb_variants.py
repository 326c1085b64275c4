"""The SVB VAE's five variants on the PyTorch port vs the JAX package, at the
tiny widths of ``tests/test_torch_svb_vae.py`` (hidden 32, latent 8, FVAE
16 wide with 2+2 WN layers, a one-layer ASR conformer; ``local`` at latent
16, the only width its LatentMap adds to), on padded B=2 batches of unequal
lengths, eval mode.

Each JAX model is initialized by flax (with seeded BatchNorm statistics),
carried to the port by ``svbvae_from_jax`` and run on the same inputs at
zero noise. Tolerances: ``m_q``/``logs_q`` 1e-4, ``mel_out`` 5e-4,
``kl``/``mle`` 1e-3, ``a2p_sample_recon`` with the same injected noise 5e-4,
the seg variant's attention weights 1e-5. The seg attention has no key
mask, so both sides see the same padded batch."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree, jax_zero_noise  # noqa: E402
from tests.test_torch_svb_vae import TINY, svbvae_inputs  # noqa: E402

from neuralsvb_tpu.models import svb_vae as jsvb  # noqa: E402
from neuralsvb_torch.convert.jax2torch import svbvae_from_jax  # noqa: E402
from neuralsvb_torch.models import svb_vae as tsvb  # noqa: E402

VARIANTS = ("mle", "tech_mle", "seg_tech_mle", "global", "local")
WAYS = ("a2a", "p2p", "a2p")


def _latent(variant):
    return 16 if variant == "local" else TINY["latent_size"]


def _jax_kwargs(variant):
    return dict(dict_size=20, hidden_size=TINY["hidden_size"], latent_size=_latent(variant),
                fvae_hidden=TINY["fvae_hidden"], fvae_kernel=5, fvae_enc_layers=2,
                fvae_dec_layers=2, mel_strides=(2, 1, 1), asr_enc_layers=1,
                asr_dec_layers=1, variant=variant)


def jax_variant(variant, inputs, seed=0):
    """A flax-initialized JAX ``SVBVAE(variant)`` with seeded BatchNorm
    statistics: (model, variables)."""
    jm = jsvb.SVBVAE(**_jax_kwargs(variant))
    rngs = {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    v = jax.device_get(jm.init(rngs, *inputs, concurrent_ways=WAYS))
    rng = np.random.RandomState(seed)

    def stats(tree):
        if isinstance(tree, dict):
            return {k: stats(t) for k, t in tree.items()}
        a = np.asarray(tree)
        return (rng.normal(0.0, 0.2, a.shape) if not a.any()
                else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    return jm, {"params": v["params"], "batch_stats": stats(v["batch_stats"])}


def port_variant(variant, v):
    tm = tsvb.SVBVAE(20, **dict(TINY, latent_size=_latent(variant)), variant=variant)
    tm.load_state_dict(svbvae_from_jax(v["params"], v["batch_stats"], variant))
    return tm.eval()


def jax_inputs(inputs):
    return tuple(a.astype(np.int32) if a.dtype == np.int64 else a for a in inputs)


@contextlib.contextmanager
def jax_injected_noise(eps, call):
    """jax.random.normal returns zeros, except ``eps`` at its ``call``-th
    call (the a2p draw comes after the a2a and p2p posteriors' draws)."""
    normal, calls = jax.random.normal, []

    def fake(key, shape=(), dtype=jnp.float32):
        calls.append(tuple(shape))
        if len(calls) == call:
            assert tuple(shape) == eps.shape, (shape, eps.shape)
            return jnp.asarray(eps, dtype)
        return jnp.zeros(shape, dtype)
    jax.random.normal = fake
    try:
        yield calls
    finally:
        jax.random.normal = normal


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_three_ways(variant):
    inputs = svbvae_inputs(seed=11)
    jin = jax_inputs(inputs)
    jm, v = jax_variant(variant, jin)
    tm = port_variant(variant, v)
    with torch.no_grad():
        rt = tm(*[torch.tensor(a) for a in inputs], zero_noise=True)
    with jax_zero_noise():
        rj = jm.apply(v, *jin, concurrent_ways=WAYS, rngs={"noise": jax.random.PRNGKey(3)})
    for way in ("a2a", "p2p"):
        agree(rt[way]["m_q"].transpose(1, 2), rj[way]["m_q"], 1e-4, f"{way} m_q")
        agree(rt[way]["logs_q"].transpose(1, 2), rj[way]["logs_q"], 1e-4, f"{way} logs_q")
        agree(rt[way]["kl"], rj[way]["kl"], 1e-3, f"{way} kl")
        agree(rt[way]["mel_out"], rj[way]["mel_out"], 5e-4, f"{way} mel_out")
    key = "mle" if variant in tsvb.MLE_VARIANTS else "kl"
    assert set(rt["a2p"]) & {"mle", "kl"} == {key} == set(rj["a2p"]) & {"mle", "kl"}
    agree(rt["a2p"][key], rj["a2p"][key], 1e-3, f"a2p {key}")
    agree(rt["a2p"]["mel_out"], rj["a2p"]["mel_out"], 5e-4, "a2p mel_out")
    if variant == "seg_tech_mle":
        agree(rt["p2p"]["attn"], rj["p2p"]["attn"], 1e-5, "seg attn")
    else:
        assert "attn" not in rt["p2p"]


@pytest.mark.parametrize("variant", ("global", "local"))
def test_a2p_sample_recon_injected_noise(variant, monkeypatch):
    """The sampled a2p decode, m + eps * exp(logs), with the same eps."""
    inputs = svbvae_inputs(seed=12)
    jin = jax_inputs(inputs)
    jm, v = jax_variant(variant, jin, seed=1)
    tm = port_variant(variant, v)
    B, T = inputs[1].shape[:2]
    Tz = 1 if variant == "global" else T // 4
    eps = np.random.RandomState(4).randn(B, Tz, _latent(variant)).astype(np.float32)
    monkeypatch.setattr(tsvb, "draw_normal", lambda shape, like, generator, zero_noise:
                        torch.tensor(eps).transpose(1, 2).to(like))
    with torch.no_grad():
        rt = tm(*[torch.tensor(a) for a in inputs], zero_noise=True)
    with jax_injected_noise(eps, 3) as calls:
        rj = jm.apply(v, *jin, concurrent_ways=WAYS, rngs={"noise": jax.random.PRNGKey(3)})
    assert len(calls) == 3, calls
    d = np.abs(np.asarray(rj["a2p"]["a2p_sample_recon"]) - np.asarray(rj["a2p"]["mel_out"]))
    assert d.max() > 1e-2  # the noise reached the decode
    agree(rt["a2p"]["a2p_sample_recon"], rj["a2p"]["a2p_sample_recon"], 5e-4,
          "a2p_sample_recon")
    agree(rt["a2p"]["mel_out"], rj["a2p"]["mel_out"], 5e-4, "a2p mel_out")


@pytest.mark.parametrize("variant", VARIANTS)
def test_state_dict_names(variant):
    """The converter fills exactly the port's ``state_dict``; the flagship
    keeps its keys, each variant has only its own maps."""
    inputs = jax_inputs(svbvae_inputs(seed=13))
    _, v = jax_variant(variant, inputs)
    sd = svbvae_from_jax(v["params"], v["batch_stats"], variant)
    tm = tsvb.SVBVAE(20, **dict(TINY, latent_size=_latent(variant)), variant=variant)
    assert set(sd) == set(tm.state_dict())
    maps = {k.split(".")[0] for k in sd if "mapping_function" in k}
    assert maps == set(tm.mapping_keys)
    assert any(k.startswith("seg_ref_attn.") for k in sd) == (variant == "seg_tech_mle")
    if variant == "mle":
        flagship = tsvb.SVBVAE(20, **TINY)
        assert list(flagship.state_dict()) == list(tm.state_dict())


def test_local_needs_latent_16():
    with pytest.raises(ValueError, match="latent_size must be 16"):
        tsvb.SVBVAE(20, **TINY, variant="local")
    with pytest.raises(ValueError, match="not one of"):
        tsvb.SVBVAE(20, **TINY, variant="boost")
