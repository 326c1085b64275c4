"""The PPG models' parts on the PyTorch port vs the JAX package, at tiny
widths (hidden 32, one conformer and one decoder layer, two decoder conv
layers), weights carried from the JAX init by ``convert.jax2torch``
(``vcppg_from_jax`` for the whole model), on padded batches. Tolerance
1e-5 (max |d|) everywhere.

The attention tests include a query row whose keys are all masked (it must
come out uniform on both sides, not NaN), and the decoder's own masks: its
first step's shifted-in 0 token is padding for the self-attention, so the
first query row is fully masked there too."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree  # noqa: E402

from neuralsvb_tpu.models import asr as jasr  # noqa: E402
from neuralsvb_tpu.models import common as jcommon  # noqa: E402
from neuralsvb_tpu.models import svb_ppg as jppg  # noqa: E402
from neuralsvb_torch.convert import jax2torch as j2t  # noqa: E402
from neuralsvb_torch.models import asr as tasr  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402
from neuralsvb_torch.models import svb_ppg as tppg  # noqa: E402
from neuralsvb_torch.models import svb_vae as tsvb  # noqa: E402

H, DICT = 32, 23
B, T, L = 3, 40, 9
LENS, TOK_LENS = (40, 31, 22), (9, 6, 4)
TOL = 1e-5
KW = dict(dict_size=DICT, hidden_size=H, asr_enc_layers=1, asr_dec_layers=1,
          ref_enc_out=32, dec_layers=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(model, *args, **kw):
    v = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                   *args, **kw)
    return _np_tree(v["params"]), _np_tree(v.get("batch_stats", {}))


def _stats(tree, seed=3):
    """Non-trivial BatchNorm running statistics (means and variances)."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        name = path[-1].key
        return ((rng.uniform(0.5, 1.5, x.shape) if name == "var"
                 else rng.normal(0.0, 0.2, x.shape)).astype(np.float32))
    return jax.tree_util.tree_map_with_path(f, tree)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    m = np.arange(T)[None] < np.asarray(LENS)[:, None]
    tm = np.arange(L)[None] < np.asarray(TOK_LENS)[:, None]
    return dict(
        mels=((rng.randn(B, T, 80) - 2) * m[..., None]).astype(np.float32),
        pitch=(rng.randint(1, 255, (B, T)) * m).astype(np.int64),
        energy=(rng.uniform(0.0, 6.0, (B, T)) * m).astype(np.float32),
        tokens=(rng.randint(4, DICT, (B, L)) * tm).astype(np.int64),
        align=np.stack([np.sort(rng.randint(0, n, T)) for n in LENS]) * m,
        spk=rng.randn(B, 5, 256).astype(np.float32))


def _mha_jax_to_torch(p, fused):
    sd = j2t._SD()
    if fused:
        j2t._mha(sd, "m", p)
    else:
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(f"m.{n}", p[n])
    return {k[2:]: v for k, v in sd.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_attention_masks(fused):
    """Key padding and an additive causal mask; batch row 1 has every key
    masked (uniform weights), row 2 only its padded tail."""
    rng = np.random.RandomState(1)
    q = rng.randn(B, 7, H).astype(np.float32)
    kv = rng.randn(B, 11, H).astype(np.float32)
    kpm = np.zeros((B, 11), bool)
    kpm[1] = True
    kpm[2, 6:] = True
    mask = np.triu(np.full((7, 11), np.finfo(np.float32).min), k=1).astype(np.float32)
    jm = jcommon.MultiheadAttention(num_heads=2)
    params, _ = _init(jm, q, kv, kv, key_padding_mask=kpm, attn_mask=mask)
    jo, jw = jm.apply({"params": params}, q, kv, kv, key_padding_mask=kpm, attn_mask=mask)
    tm = tcommon.MultiheadAttention(H, 2, fused_in_proj=fused).eval()
    tm.load_state_dict(_mha_jax_to_torch(params, fused))
    with torch.no_grad():
        to, tw = tm(torch.tensor(q), torch.tensor(kv), torch.tensor(kv),
                    torch.tensor(kpm), torch.tensor(mask))
    assert torch.isfinite(tw).all()
    np.testing.assert_allclose(tw[1].numpy(), 1.0 / 11, atol=1e-7)
    agree(tw, jw, TOL, "weights")
    agree(to, jo, TOL, "out")


def test_causal_mask_and_positions():
    np.testing.assert_array_equal(tcommon.causal_mask(6).numpy(),
                                  np.asarray(jcommon.causal_mask(6)))
    nonpad = np.arange(8)[None] < np.asarray([[8], [5], [0]])
    nonpad = nonpad.copy()
    nonpad[1, 0] = False  # a leading pad step, as the decoder's first input
    jpos = jcommon.SinusoidalPositionalEmbedding(12).apply({}, nonpad)
    tpos = tcommon.SinusoidalPositionalEmbedding(12)(torch.tensor(nonpad))
    agree(tpos, jpos, 0.0, "positions")


def test_dec_sa_layer():
    rng = np.random.RandomState(2)
    x = rng.randn(B, L, H).astype(np.float32)
    enc = rng.randn(B, 13, H).astype(np.float32)
    self_pad = np.arange(L)[None] >= np.asarray(TOK_LENS)[:, None]
    self_pad[:, 0] = True
    enc_pad = np.arange(13)[None] >= np.asarray([13, 7, 3])[:, None]
    mask = np.asarray(jcommon.causal_mask(L))[None, None]
    jm = jcommon.DecSALayer(H, 2)
    args = (x, enc, enc_pad, mask, self_pad)
    params, _ = _init(jm, *args)
    jx, jw = jm.apply({"params": params}, *args)
    sd = j2t._SD()
    j2t._asr_decoder(sd, "d", {"layer_0": params, "layer_norm": {
        "scale": np.ones(H, np.float32), "bias": np.zeros(H, np.float32)},
        "project_out": {"kernel": np.zeros((H, 1), np.float32)}})
    tm = tcommon.DecSALayer(H, 2).eval()
    tm.load_state_dict({k[len("d.layers.0.op."):]: v for k, v in sd.items()
                        if k.startswith("d.layers.0.op.")})
    with torch.no_grad():
        tx, tw = tm(*(torch.tensor(a) for a in (x, enc, enc_pad, mask[0, 0], self_pad)))
    agree(tx, jx, TOL, "x")
    agree(tw, jw, TOL, "encoder attention")


@pytest.fixture(scope="module")
def vcasr():
    """The JAX VCASR with its decoder head and the port's, same weights."""
    inp = _inputs()
    prev = np.pad(inp["tokens"][:, :-1], ((0, 0), (1, 0)))
    jm = jasr.VCASR(DICT, H, 1, 1)
    params, stats = _init(jm, inp["mels"], prev)
    stats = _stats(stats)
    tm = tasr.VCASR(DICT, H, 1, asr_dec_layers=1, with_decoder=True).eval()
    tm.load_state_dict(j2t.vcasr_from_jax(params, stats))
    return jm, {"params": params, "batch_stats": stats}, tm, inp, prev


def test_transformer_asr_decoder(vcasr):
    jm, var, tm, inp, prev = vcasr
    rng = np.random.RandomState(4)
    enc = rng.randn(B, 13, H).astype(np.float32) * (
        np.arange(13)[None] < np.asarray([13, 9, 5])[:, None])[..., None]
    emb = np.asarray(jcommon.Embedding(DICT, H, 0).apply(
        {"params": var["params"]["token_embed"]}, prev))
    jd = jasr.TransformerASRDecoder(H, 1, 0.1, DICT)
    jlog, jattn = jd.apply({"params": var["params"]["asr_decoder"]}, emb, enc)
    with torch.no_grad():
        tlog, tattn = tm.asr_decoder(torch.tensor(emb), torch.tensor(enc))
    agree(tlog, jlog, TOL, "logits")
    agree(tattn[0], jattn[0], TOL, "attention")


def test_vcasr_with_head(vcasr):
    jm, var, tm, inp, prev = vcasr
    jo = jm.apply(var, inp["mels"], prev)
    with torch.no_grad():
        to = tm(torch.tensor(inp["mels"]).transpose(1, 2), True, torch.tensor(prev))
    agree(to["h_content"].transpose(1, 2), jo["h_content"], TOL, "h_content")
    agree(to["tokens"], jo["tokens"], TOL, "tokens")
    agree(to["asr_attn"][0], jo["asr_attn"][0], TOL, "asr_attn")


def test_flagship_vcasr_keys_unchanged():
    """The flagship's VCASR has no decoder: its state_dict keys are those of
    the JAX flagship's tree, and the decoder only adds keys."""
    from neuralsvb_torch.models.asr import VCASR
    flagship = tsvb.SVBVAE(DICT, H, latent_size=8, fvae_hidden=16, fvae_enc_layers=2,
                           fvae_dec_layers=2, asr_enc_layers=1)
    own = {k for k in flagship.vc_asr.state_dict() if not k.endswith("num_batches_tracked")}
    jm = jasr.VCASR(DICT, H, 1, 1)
    params, stats = _init(jm, np.zeros((1, 16, 80), np.float32))
    assert own == {k for k in j2t.vcasr_from_jax(params, stats)
                   if not k.endswith("num_batches_tracked")}
    with_head = {k for k in VCASR(DICT, H, 1, with_decoder=True, asr_dec_layers=1).state_dict()
                 if not k.endswith("num_batches_tracked")}
    assert own < with_head
    assert all(k.startswith(("token_embed.", "asr_decoder.")) for k in with_head - own)


def _jax_vcppg(cls, para):
    """A JAX PPG model initialised as ``SVBParaTask.build_generator`` does
    (three merged inits), with non-trivial BatchNorm statistics."""
    jm = cls(**KW)
    Bi, Ti = 2, 32
    mels = np.zeros((Bi, Ti, 80), np.float32)
    pitch = np.ones((Bi, Ti), np.int32)
    energy = np.zeros((Bi, Ti), np.float32)
    tech = np.zeros((Bi,), np.int32)
    align = np.zeros((Bi, Ti), np.int32)
    spk = np.zeros((Bi, 5, 256), np.float32) if para else None
    p1, s1 = _init(jm, mels, mels, pitch, energy, spk, tech, align)
    p2, s2 = _init(jm, mels, np.ones((Bi, 8), np.int32), method=jm.train_vc_asr)
    p3, s3 = _init(jm, mels, mels, pitch, energy, None, tech, align)

    def merge(a, b):
        if not isinstance(a, dict):
            return a
        out = dict(a)
        for k, v in b.items():
            out[k] = merge(a[k], v) if k in a else v
        return out
    return jm, merge(merge(p1, p2), p3), _stats(merge(merge(s1, s2), s3))


@pytest.mark.parametrize("para", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_ppg_model_forward(para, train, monkeypatch):
    """``VCPPG`` (reference encoder) and ``ParaSVBPPG`` (speaker embedding
    0, the PPG gathered through the alignment, a technique) forward, in
    eval and in training mode (batch statistics in the upsampler, dropout
    keeping every element on both sides, the 1/(1-p) scaling kept)."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    jcls, tcls = (jppg.ParaSVBPPG, tppg.ParaSVBPPG) if para else (jppg.VCPPG, tppg.VCPPG)
    jm, params, stats = _jax_vcppg(jcls, para)
    tm = tcls(**KW)
    tm.load_state_dict(j2t.vcppg_from_jax(params, stats))
    tm.train(train)
    assert not tm.vc_asr.training
    inp = _inputs()
    spk = inp["spk"] if para else None
    tech = np.asarray([0, 1, 1]) if para else None
    align = inp["align"] if para else None
    jo, mut = jm.apply({"params": params, "batch_stats": stats}, inp["mels"], inp["mels"],
                       inp["pitch"], inp["energy"], spk, tech, align, train=train,
                       rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    with torch.no_grad():
        to = tm(torch.tensor(inp["mels"]), torch.tensor(inp["mels"]),
                torch.tensor(inp["pitch"]), torch.tensor(inp["energy"]),
                None if spk is None else torch.tensor(spk),
                None if tech is None else torch.tensor(tech),
                None if align is None else torch.tensor(align),
                generator=torch.Generator())
    for k in ("h_pitch", "h_content", "h_energy", "h_style", "dec_inputs"):
        agree(to[k].transpose(1, 2), jo[k], TOL, k)
    agree(to["mel_out"], jo["mel_out"], TOL, "mel_out")
    new = j2t.vcppg_from_jax(params, _np_tree(mut["batch_stats"]))
    for k, v in tm.state_dict().items():
        if "running" in k:
            agree(v, new[k].numpy(), TOL, k)


def test_train_vc_asr():
    jm, params, stats = _jax_vcppg(jppg.VCPPG, False)
    tm = tppg.VCPPG(**KW).train()
    tm.load_state_dict(j2t.vcppg_from_jax(params, stats))
    inp = _inputs(5)
    jl = jm.apply({"params": params, "batch_stats": stats}, inp["mels"], inp["tokens"],
                  method=jm.train_vc_asr)
    with torch.no_grad():
        tl = tm.train_vc_asr(torch.tensor(inp["mels"]), torch.tensor(inp["tokens"]))
    agree(tl, jl, TOL, "logits")


@pytest.mark.parametrize("option", [dict(asr_enc_type="conv"), dict(ref_attn=True),
                                    dict(pre_exp=True), dict(aligned_asr=True)])
def test_unported_options_raise(option):
    """The four ``VCPPG`` options the port once refused (``NotImplementedError``)
    now build and run: each one's state_dict carries the JAX tree's keys and
    shapes, and its eval forward through the reference encoder, with an
    alignment, matches the JAX model's (the SVBPara family's variants in
    training mode: ``tests/test_torch_svb_para.py``)."""
    import functools
    jm, params, stats = _jax_vcppg(functools.partial(jppg.VCPPG, **option), False)
    sd = j2t.vcppg_from_jax(params, stats)
    tm = tppg.VCPPG(**KW, **option).eval()
    own = tm.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
    tm.load_state_dict(sd)
    inp = _inputs()
    jo = jm.apply({"params": params, "batch_stats": stats}, inp["mels"], inp["mels"],
                  inp["pitch"], inp["energy"], None, None, inp["align"])
    with torch.no_grad():
        to = tm(*(torch.tensor(inp[k]) for k in ("mels", "mels", "pitch", "energy")),
                None, None, torch.tensor(inp["align"]))
    for k in ("h_content", "dec_inputs"):
        agree(to[k].transpose(1, 2), jo[k], TOL, k)
    agree(to["mel_out"], jo["mel_out"], TOL, "mel_out")


def test_state_dict_round_trip_keys():
    """Every key of the port's models comes from the JAX tree."""
    for jcls, tcls, para in ((jppg.VCPPG, tppg.VCPPG, False),
                             (jppg.SVBPPG, tppg.SVBPPG, False),
                             (jppg.ParaSVBPPG, tppg.ParaSVBPPG, True)):
        _, params, stats = _jax_vcppg(jcls, para)
        sd = j2t.vcppg_from_jax(params, stats)
        own = tcls(**KW).state_dict()
        assert set(sd) == set(own)
        assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
