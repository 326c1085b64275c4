"""The FastSpeech2 family's modules in the port against the JAX package at
tiny widths: the length regulator and its inverse, the FFT encoder, the
whole ``FastSpeech2`` (both decoders, frame and CWT pitch, a speaker id or
embedding, energy, predicted durations), ``PitchExtractor``, the CWT (numpy
and torch) and ``ParaSVBPPG`` with ``decoder_type: fft``.

Weights are the JAX model's, carried over by ``convert/jax2torch.py``
(``fs2_from_jax``, ``pitch_extractor_from_jax``, ``vcppg_from_jax``); inputs
are seeded numpy. In training mode both sides draw the same dropout masks:
a fixed pattern of the mask's shape replaces ``jax.random.bernoulli`` and
the port's ``dropout_keep_mask`` (the layouts of the FFT blocks' and the
predictors' dropouts are the same on both sides). Floats agree within
``TOL`` (1e-5 of each output's scale, the tolerance of the port's earlier
model tests), integer outputs exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree  # noqa: E402

from neuralsvb_torch.convert import jax2torch as j2t  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402

TOL = 1e-5
DICT, H, B, L, T = 20, 32, 3, 7, 40
TOK_LENS, LENS = (7, 5, 6), (40, 28, 33)


def keep_pattern(shape, rate):
    """A fixed keep-mask of ``shape`` with about ``rate`` dropped."""
    n = int(np.prod(shape))
    return ((np.arange(n) * 7919 + 13) % 100 >= round(rate * 100)).reshape(shape)


@pytest.fixture
def patterned(monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(keep_pattern(shape, 1 - p)))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.as_tensor(keep_pattern(tuple(shape), rate), device=device))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scale_agree(a, b, name, scale=1.0):
    agree(a, b, TOL * max(scale, float(np.abs(np.asarray(b)).max())), name)


def _inputs(seed=0):
    from neuralsvb_tpu.ops.pitch_utils import norm_interp_f0
    rng = np.random.RandomState(seed)
    tm = np.arange(L)[None] < np.asarray(TOK_LENS)[:, None]
    tokens = (rng.randint(4, DICT, (B, L)) * tm).astype(np.int64)
    mel2ph = np.zeros((B, T), np.int64)
    for b, (n, fl) in enumerate(zip(TOK_LENS, LENS)):
        dur = rng.multinomial(fl - n, np.ones(n) / n) + 1
        mel2ph[b, :fl] = np.repeat(np.arange(1, n + 1), dur)
    hp = {"pitch_norm": "standard", "f0_mean": 200.0, "f0_std": 30.0, "use_uv": True}
    f0s, uvs = [], []
    for fl in LENS:
        f0 = 200 + 30 * np.sin(np.arange(T) / 4.0 + fl)
        f0[fl:] = 0
        f0[:3] = 0
        f0n, uv = norm_interp_f0(f0, hp)
        f0s.append(f0n * (np.arange(T) < fl))
        uvs.append(uv)
    m = (np.arange(T)[None] < np.asarray(LENS)[:, None]).astype(np.float32)
    return dict(tokens=tokens, mel2ph=mel2ph, f0=np.stack(f0s).astype(np.float32),
                uv=np.stack(uvs).astype(np.float32),
                energy=(rng.uniform(0, 40, (B, T)) * m).astype(np.float32),
                spk_id=np.asarray([0, 3, 1]), spk_embed=rng.randn(B, 256).astype(np.float32),
                mels=((rng.randn(B, T, 80) - 2) * m[..., None]).astype(np.float32))


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# length regulator, durations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha, max_len", [(1.0, None), (0.5, None), (1.5, 12), (1.0, 60)])
def test_length_regulator_matches_jax(alpha, max_len):
    from neuralsvb_tpu.models import tts_modules as jtm
    from neuralsvb_torch.models import tts_modules as ttm
    dur = np.asarray([[3, 1, 5, 2, 0, 0], [1, 1, 1, 7, 3, 2], [5, 3, 2, 2, 4, 0]])
    pad = dur == 0
    pad[1, 5] = True  # a padded token with a duration counts for nothing
    want = np.asarray(jtm.length_regulator(jnp.asarray(dur), jnp.asarray(pad), alpha, max_len))
    got = ttm.length_regulator(torch.as_tensor(dur), torch.as_tensor(pad), alpha, max_len)
    np.testing.assert_array_equal(got.numpy(), want)  # 0.5 x odd: half-way, to even
    for T_txt in (6, 4):  # 4: indices past T_txt count nowhere
        np.testing.assert_array_equal(
            ttm.mel2ph_to_dur(got, T_txt).numpy(),
            np.asarray(jtm.mel2ph_to_dur(jnp.asarray(want), T_txt)))
    x = np.log(np.asarray([[0.5, 1.5, 2.5, 3.49, 0.2, 7.0]]) + 1).astype(np.float32)
    np.testing.assert_array_equal(
        ttm.DurationPredictor.out2dur(torch.as_tensor(x)).numpy(),
        np.asarray(jtm.DurationPredictor.out2dur(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# the FFT encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_fft_encoder_matches_jax(train, patterned):
    from neuralsvb_tpu.models.tts_modules import FastspeechEncoder as J
    from neuralsvb_torch.models.tts_modules import FastspeechEncoder as Tm
    inp = _inputs()
    jm = J(DICT, H, 2, 5, 2, 0.1)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                inp["tokens"])
    params = _np_tree(v["params"])
    want = jm.apply({"params": params}, inp["tokens"], train=train,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    sd = j2t._SD()  # fs2_from_jax's encoder part
    sd.put("embed_tokens.weight", params["embed_tokens"]["Embed_0"]["embedding"])
    j2t._fft_blocks(sd, "blocks", params["blocks"])
    tm = Tm(DICT, H, 2, 5, 2, 0.1)
    tm.load_state_dict(sd)
    tm.train(train)
    with torch.no_grad():
        got = tm(_t(inp["tokens"]), torch.Generator())
    _scale_agree(got, want, f"encoder (train={train})")
    assert float(got[1, TOK_LENS[1]:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# FastSpeech2
# ---------------------------------------------------------------------------

CASES = {
    "fft-frame-id": dict(decoder_type="fft", use_spk_id=True),
    "conv-frame-embed-energy": dict(decoder_type="conv", use_spk_embed=True,
                                    use_energy_embed=True),
    "fft-cwt": dict(decoder_type="fft", pitch_type="cwt"),
    "conv-predicted": dict(decoder_type="conv", use_energy_embed=True, use_spk_id=True),
    "fft-cwt-predicted": dict(decoder_type="fft", pitch_type="cwt", use_spk_embed=True),
}
# which inputs a case leaves to the predictors: mel2ph (durations), f0/uv, energy
PREDICTED = {"conv-predicted": ("mel2ph", "f0", "energy"),
             "fft-cwt-predicted": ("mel2ph", "f0")}


def _fs2_kw(case):
    return dict(dict_size=DICT, hidden_size=H, enc_layers=2, dec_layers=2,
                enc_ffn_kernel_size=5, dec_ffn_kernel_size=5, num_heads=2, out_dims=80,
                num_spk=5, predictor_hidden=24, predictor_layers=2, dur_predictor_layers=2,
                predictor_grad=0.1, dropout=0.1, cwt_hidden_size=16, f0_mean=200.0,
                f0_std=30.0, **CASES[case])


@functools.lru_cache(maxsize=None)
def jax_fs2(case):
    """The JAX model, initialised as ``FastSpeech2Task.build_generator``,
    and its params as numpy (one init per case for the module)."""
    from neuralsvb_tpu.models.fs2 import FastSpeech2
    kw = _fs2_kw(case)
    jm = FastSpeech2(**kw)
    Bi, Ti, Tm = 2, 8, 32
    spk = (np.zeros((Bi,), np.int32) if kw.get("use_spk_id") else
           np.zeros((Bi, 256), np.float32) if kw.get("use_spk_embed") else None)
    f0 = np.zeros((Bi, Tm), np.float32)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                np.ones((Bi, Ti), np.int32), np.ones((Bi, Tm), np.int32), spk, f0, f0,
                f0 if kw.get("use_energy_embed") else None)
    return jm, _np_tree(v["params"])


def torch_fs2(case, params):
    from neuralsvb_torch.models.fs2 import FastSpeech2
    tm = FastSpeech2(**_fs2_kw(case))
    tm.load_state_dict(j2t.fs2_from_jax(params))
    return tm


def _fs2_args(case, inp):
    kw = CASES[case]
    pred = PREDICTED.get(case, ())
    spk = (inp["spk_id"] if kw.get("use_spk_id") else
           inp["spk_embed"] if kw.get("use_spk_embed") else None)
    return (inp["tokens"], None if "mel2ph" in pred else inp["mel2ph"], spk,
            None if "f0" in pred else inp["f0"], None if "f0" in pred else inp["uv"],
            None if "energy" in pred else inp["energy"])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_fs2_forward_matches_jax(case, train, patterned):
    inp = _inputs(1)
    jm, params = jax_fs2(case)
    tm = torch_fs2(case, params).train(train)
    args = _fs2_args(case, inp)
    max_frames = T if args[1] is None else None
    want = jm.apply({"params": params}, *args, max_frames=max_frames, train=train,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    with torch.no_grad():
        got = tm(*map(_t, args), max_frames=max_frames, generator=torch.Generator())
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in sorted(want):
        if np.issubdtype(np.asarray(want[k]).dtype, np.integer):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        else:  # f0 in Hz passes through f0_mean (200 Hz): its rounding
            _scale_agree(got[k], want[k], f"{case} {k}", 200.0 if k == "f0_denorm" else 1.0)
    if args[1] is None:  # predicted durations fill max_frames
        assert got["mel2ph"].shape == (B, T)


def test_fs2_predictor_grad_scales_only_the_predictors():
    """``predictor_grad`` 0 leaves the encoder without the predictors'
    gradient; the mel loss alone reaches it either way."""
    case = "conv-frame-embed-energy"
    inp = _inputs(2)
    _, params = jax_fs2(case)
    args = list(map(_t, _fs2_args(case, inp)))
    grads = {}
    for g in (0.0, 0.1):
        tm = torch_fs2(case, params).eval()
        tm.predictor_grad = g
        out = tm(*args)
        out["dur"].sum().backward()
        grads[g] = tm.encoder.embed_tokens.weight.grad
    assert grads[0.0] is None or float(grads[0.0].abs().max()) == 0.0
    assert float(grads[0.1].abs().max()) > 0


# ---------------------------------------------------------------------------
# the pitch extractor, the CWT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_pitch_extractor_matches_jax(train, patterned):
    from neuralsvb_tpu.models.pe import PitchExtractor as J
    from neuralsvb_torch.models.pe import PitchExtractor as Tm
    inp = _inputs(3)
    kw = dict(hidden_size=H, conv_layers=2, predictor_hidden=24, f0_mean=200.0, f0_std=30.0)
    jm = J(**kw)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                inp["mels"])
    params = _np_tree(v["params"])
    rs = np.random.RandomState(4)
    stats = jax.tree_util.tree_map(
        lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32), _np_tree(v["batch_stats"]))
    want, mut = jm.apply({"params": params, "batch_stats": stats}, inp["mels"], train=train,
                         rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
    tm = Tm(**kw)
    tm.load_state_dict(j2t.pitch_extractor_from_jax(params, stats))
    tm.train(train)
    with torch.no_grad():
        got = tm(_t(inp["mels"]), torch.Generator())
    for k in ("pitch_pred", "f0_denorm_pred"):
        _scale_agree(got[k], want[k], f"pe {k} (train={train})")
    if train:  # the prenet's running statistics moved alike
        bn = mut["batch_stats"]["mel_prenet"]["BatchNorm1d_0"]["BatchNorm_0"]
        _scale_agree(tm.mel_prenet.layers[0][2].running_mean, bn["mean"], "running mean")


def test_cwt_matches_jax():
    from neuralsvb_tpu.ops import cwt as jc
    from neuralsvb_torch.ops import cwt as tc
    rng = np.random.RandomState(5)
    f0 = 200 + 25 * np.sin(np.arange(150) / 6.0) + rng.randn(150)
    f0[:5], f0[60:70], f0[-4:] = 0, 0, 0
    for a, b in zip(tc.get_cont_lf0(f0), jc.get_cont_lf0(f0)):
        np.testing.assert_array_equal(a, b)
    _, lf0 = tc.get_cont_lf0(f0)
    lf0n = (lf0 - lf0.mean()) / lf0.std()
    for a, b in zip(tc.get_lf0_cwt(lf0n), jc.get_lf0_cwt(lf0n)):
        np.testing.assert_array_equal(a, b)
    spec = tc.get_lf0_cwt(lf0n)[0]
    for a, b in zip(tc.norm_scale(spec), jc.norm_scale(spec)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc.convert_continuous_f0(np.zeros(5))[1], np.zeros(5))
    # the model's side: numpy exactly, torch within float32 rounding
    specs = np.stack([spec, spec[::-1]])[:, :140].astype(np.float32)
    mean, std = np.asarray([5.2, 5.4], np.float32), np.asarray([0.2, 0.3], np.float32)
    scales = tc.cwt_scales()
    np.testing.assert_array_equal(scales, (2 * jc.CWT_DT) * 2.0 ** (jc.CWT_DJ * np.arange(10)))
    np.testing.assert_array_equal(tc.inverse_cwt(specs, scales), jc.inverse_cwt(specs, scales))
    hp = {"pitch_norm": "standard", "f0_mean": 200.0, "f0_std": 30.0, "use_uv": True}
    for mel_len in (140, 150):  # 150: padded with the last frame
        m2p = np.ones((2, mel_len), np.int64)
        want = np.asarray(jc.cwt2f0_norm(jnp.asarray(specs), jnp.asarray(mean),
                                         jnp.asarray(std), m2p, hp))
        np.testing.assert_array_equal(tc.cwt2f0_norm(specs, mean, std, m2p, hp),
                                      jc.cwt2f0_norm(specs, mean, std, m2p, hp))
        got = tc.cwt2f0_norm(_t(specs), _t(mean), _t(std), m2p, hp)
        _scale_agree(got, want, f"cwt2f0_norm ({mel_len})")
    got = tc.inverse_cwt(_t(specs), scales)
    _scale_agree(got, jc.inverse_cwt(jnp.asarray(specs), scales), "inverse_cwt")


def test_pitch_utils_on_tensors_match_jax():
    from neuralsvb_tpu.ops import pitch_utils as jp
    from neuralsvb_torch.ops import pitch_utils as tp
    f0 = np.concatenate([[0.0, 30.0, 49.9, 50.0], np.linspace(60, 1200, 200)]).astype(np.float32)
    np.testing.assert_array_equal(tp.f0_to_coarse(torch.as_tensor(f0)).numpy(),
                                  np.asarray(jp.f0_to_coarse(jnp.asarray(f0))))
    uv = (f0 < 50).astype(np.float32)
    for norm in ("standard", "log"):
        hp = {"pitch_norm": norm, "f0_mean": 200.0, "f0_std": 30.0, "use_uv": True}
        _scale_agree(tp.norm_f0(torch.as_tensor(f0), torch.as_tensor(uv), hp),
                     jp.norm_f0(jnp.asarray(f0), jnp.asarray(uv), hp), f"norm_f0 {norm}")


# ---------------------------------------------------------------------------
# ParaSVBPPG with the FFT decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_para_svb_ppg_fft_decoder_matches_jax(train, patterned):
    from tests import test_torch_vcppg as vc
    from neuralsvb_tpu.models import svb_ppg as jppg
    from neuralsvb_torch.models import svb_ppg as tppg
    kw = dict(vc.KW, decoder_type="fft", dec_ffn_kernel_size=5, num_heads=2)
    saved = vc.KW
    vc.KW = kw
    try:
        jm, params, stats = vc._jax_vcppg(jppg.ParaSVBPPG, True)
    finally:
        vc.KW = saved
    tm = tppg.ParaSVBPPG(**kw)
    tm.load_state_dict(j2t.vcppg_from_jax(params, stats))
    tm.train(train)
    inp = vc._inputs()
    tech = np.asarray([0, 1, 1])
    jo, _ = jm.apply({"params": params, "batch_stats": stats}, inp["mels"], inp["mels"],
                     inp["pitch"], inp["energy"], inp["spk"], tech, inp["align"], train=train,
                     rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    with torch.no_grad():
        to = tm(*map(torch.tensor, (inp["mels"], inp["mels"], inp["pitch"], inp["energy"],
                                    inp["spk"], tech, inp["align"])),
                generator=torch.Generator())
    _scale_agree(to["mel_out"], jo["mel_out"], f"ParaSVBPPG fft mel_out (train={train})")
