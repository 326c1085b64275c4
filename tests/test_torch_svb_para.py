"""The SVBPara family's PPG models on the PyTorch port vs the JAX package, at
tiny widths (hidden 32, one conformer and one ASR decoder layer, two
decoder conv layers), weights carried from the JAX init by
``vcppg_from_jax``, on padded batches: ``ParaPPGPreExp`` (the mel gathered
before the ASR), ``ParaAlignedPPG`` and ``ParaPPGConstraint`` (the content
rows realigned inside the ASR), ``ref_attn`` (the banded attention over the
timbre mel) and ``asr_enc_type: conv``; in eval and in training mode (batch
statistics in the upsampler, dropout keeping every element on both sides,
its 1/(1-p) scaling kept). Then ``train_vc_asr`` with the alignment and
``with_hidden``: the realigned rows carry one extra pooled frame, all zeros,
which the decoder's mask reads as padding. Last, ``ConvStacks``' strides,
``res`` and norms. Tolerance 1e-5 (max |d|).

Both sides compute in float64 (``jax.enable_x64`` on the JAX
side): in float32 the training-mode upsampler's batch statistics over the
realigned rows put each side about 1e-5 from the float64 result (port
1.17e-5, JAX 0.90e-5 on ``h_content`` of magnitude 2.6), so a float32
comparison would measure rounding, not the port."""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import enable_x64  # noqa: E402

from tests.test_torch_support import agree, one_torch_thread  # noqa: E402,F401
from tests.test_torch_vcppg import KW, TOL, _inputs, _jax_vcppg, _np_tree  # noqa: E402

from neuralsvb_tpu.models import svb_ppg as jppg  # noqa: E402
from neuralsvb_torch.convert import jax2torch as j2t  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402
from neuralsvb_torch.models import svb_ppg as tppg  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VARIANTS = {
    "pre_exp": (jppg.ParaPPGPreExp, tppg.ParaPPGPreExp, {}),
    "aligned": (jppg.ParaAlignedPPG, tppg.ParaAlignedPPG, {}),
    "constraint": (jppg.ParaPPGConstraint, tppg.ParaPPGConstraint, {}),
    "ref_attn": (jppg.ParaSVBPPG, tppg.ParaSVBPPG, dict(ref_attn=True)),
    "conv_asr": (jppg.ParaSVBPPG, tppg.ParaSVBPPG, dict(asr_enc_type="conv")),
}
_BUILT = {}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _models(variant):
    """(JAX model, float64 params, stats, float64 port model) of a
    variant, built once."""
    if variant not in _BUILT:
        jcls, tcls, opt = VARIANTS[variant]
        jm, params, stats = _jax_vcppg(functools.partial(jcls, **opt), True)
        params, stats = _f64(params), _f64(stats)
        tm = tcls(**KW, **opt).double()
        tm.load_state_dict(j2t.vcppg_from_jax(params, stats))
        _BUILT[variant] = jm, params, stats, tm
    return _BUILT[variant]


@pytest.fixture
def keep_all(monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_para_variant_forward(variant, train, keep_all):
    jm, params, stats, tm = _models(variant)
    tm.load_state_dict(j2t.vcppg_from_jax(params, stats))  # fresh statistics
    tm.train(train)
    inp = _f64(_inputs())
    tech = np.asarray([0, 1, 1])
    with enable_x64():
        jo, mut = jm.apply({"params": params, "batch_stats": stats}, inp["mels"], inp["mels"],
                           inp["pitch"], inp["energy"], inp["spk"], tech, inp["align"],
                           train=train, rngs={"dropout": jax.random.PRNGKey(0)},
                           mutable=["batch_stats"])
    with torch.no_grad():
        to = tm(*(torch.tensor(inp[k]) for k in ("mels", "mels", "pitch", "energy", "spk")),
                torch.tensor(tech), torch.tensor(inp["align"]), generator=torch.Generator())
    for k in ("h_pitch", "h_content", "h_energy", "h_style", "dec_inputs"):
        agree(to[k].transpose(1, 2), jo[k], TOL, k)
    agree(to["mel_out"], jo["mel_out"], TOL, "mel_out")
    new = j2t.vcppg_from_jax(params, _np_tree(mut["batch_stats"]))
    for k, v in tm.state_dict().items():
        if "running" in k:
            agree(v, new[k].numpy(), TOL, k)


@pytest.mark.parametrize("variant", ["pre_exp", "aligned", "constraint", "conv_asr"])
def test_train_vc_asr_with_alignment(variant):
    """Logits and content rows of ``train_vc_asr(mels, tokens, alignment,
    with_hidden=True)``; the rows carry the CE loss's gradient."""
    jm, params, stats, tm = _models(variant)
    tm.load_state_dict(j2t.vcppg_from_jax(params, stats))
    tm.train()
    inp = _f64(_inputs(5))
    with enable_x64():
        jl, jh = jm.apply({"params": params, "batch_stats": stats}, inp["mels"],
                          inp["tokens"], inp["align"], with_hidden=True,
                          method=jm.train_vc_asr)
    tl, th = tm.train_vc_asr(torch.tensor(inp["mels"]), torch.tensor(inp["tokens"]),
                             torch.tensor(inp["align"]), with_hidden=True)
    agree(tl.detach(), jl, TOL, "logits")
    agree(th.detach(), jh, TOL, "h_content")
    assert th.requires_grad
    T = inp["align"].shape[1]
    if variant in ("aligned", "constraint"):
        # one pooled row past ceil(T / 2), all zeros: padding for the decoder
        assert th.shape[1] == -(-T // 2) + 1
        assert float(th[:, -1].detach().abs().max()) == 0.0
    else:
        assert th.shape[1] == -(-T // 2)


def test_ref_attn_mask_is_the_band():
    m = tppg.ref_attn_mask(40, 5, torch.float32, "cpu").numpy()
    t, k = np.arange(40)[:, None], np.arange(5)[None]
    np.testing.assert_array_equal(m == 0, np.abs(t - 8 * k) < 32)
    assert (m[m != 0] == -1e9).all()


@pytest.mark.parametrize("norm,strides,res,masked", [
    ("gn", (2, 1, 1), True, True), ("bn", (1, 1, 1), True, False),
    ("in", (1, 2, 1), False, True), ("none", (2, 2, 1), False, False)])
def test_conv_stacks_options_match_jax(norm, strides, res, masked):
    """``ConvStacks``' strides, ``res`` and norms (the ``ref_attn`` key
    encoder's is strided, without ``res`` or a norm) against the JAX
    module, in training mode (BatchNorm's batch statistics), the mask
    subsampled by each stride."""
    from neuralsvb_tpu.models import common as jcommon
    rng = np.random.RandomState(4)
    x = rng.randn(3, 20, 24).astype(np.float32)
    m = (np.arange(20)[None] < np.asarray([[20], [13], [7]]))[..., None].astype(np.float32)
    mask = m if masked else None
    jm = jcommon.ConvStacks(n_layers=3, n_chans=32, odim=16, strides=strides, res=res,
                            norm=norm)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), x, x_mask=mask))
    jo, mut = jm.apply(v, x, train=True, x_mask=mask, mutable=["batch_stats"])
    sd = j2t._SD()
    j2t._conv_stacks(sd, "c", v["params"], v.get("batch_stats"))
    tm = tcommon.ConvStacks(24, n_layers=3, n_chans=32, odim=16, strides=strides, res=res,
                            norm=norm).train()
    tm.load_state_dict({k[2:]: t for k, t in sd.items()})
    with torch.no_grad():
        to = tm(torch.tensor(x).transpose(1, 2),
                None if mask is None else torch.tensor(mask).transpose(1, 2))
    agree(to.transpose(1, 2), jo, TOL, f"ConvStacks {norm}")
    if norm == "bn":
        new = j2t._SD()
        j2t._conv_stacks(new, "c", v["params"], _np_tree(mut["batch_stats"]))
        for k, t in tm.state_dict().items():
            if "running" in k:
                agree(t, new[f"c.{k}"].numpy(), TOL, k)
