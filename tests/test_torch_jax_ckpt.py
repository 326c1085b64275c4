"""The port reads the JAX package's msgpack files without flax
(``neuralsvb_torch/convert/msgpack_ckpt.py``): checkpoints written on the
CPU by ``neuralsvb_tpu/training/checkpoint.save_checkpoint`` and
``params.msgpack`` files written by ``flax.serialization.to_bytes``.

- The flagship SVB VAE (tiny widths, flax-initialized, every leaf and
  BatchNorm statistic given seeded noise): ``--infer``'s ``restore`` reads
  the whole model exactly (``svbvae_from_jax`` of the checkpoint's params
  and batch statistics) and its forward agrees with the JAX one within
  1e-5; ``load_ckpt`` and
  ``pretrain_asr_ckpt`` take the parameters only, as the JAX package's
  ``load_sub_params`` does.
- HiFiGAN and PWG: each vocoder reads a ``params.msgpack`` directory and a
  JAX training checkpoint to the same weights, and vocodes as the JAX
  vocoder does from the same ``params.msgpack`` (within 1e-5).
- Every file decodes to the tree flax's ``msgpack_restore`` gives; a
  bfloat16 leaf and a chunked array decode bit-exact; a malformed file
  raises ``ValueError``.
- ``chip_smoke.py``'s flax-format encoder and HiFiGAN tree layout (its
  phase 15) read back through flax exactly."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
yaml = pytest.importorskip("yaml")

import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from tests.test_cycle import TINY  # noqa: E402
from tests.test_torch_pwg import HOP, TINY as PWG_TINY, jax_generator  # noqa: E402
from tests.test_torch_support import agree, jax_zero_noise  # noqa: E402
from tests.test_torch_svb_vae import svbvae_inputs  # noqa: E402

from neuralsvb_tpu.models import hifigan as jhifigan  # noqa: E402
from neuralsvb_tpu.models import svb_vae as jsvb  # noqa: E402
from neuralsvb_tpu.training.checkpoint import save_checkpoint  # noqa: E402
from neuralsvb_torch.convert import msgpack_ckpt  # noqa: E402
from neuralsvb_torch.convert.jax2torch import (hifigan_from_jax, pwg_from_jax,  # noqa: E402
                                               svbvae_from_jax)
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICT_SIZE = 100  # the port's ASR dictionary without a phone_set.json
SVB_HP = dict(TINY, device="cpu", zero_noise=True, mesh_shape="")
GEN = dict(upsample_rates=(8, 4, 4), upsample_kernel_sizes=(16, 8, 8),
           upsample_initial_channel=16, resblock="1", resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3), (1, 3)), use_pitch_embed=True,
           audio_sample_rate=22050, num_mels=80)


def _noisy(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(np.float32), tree)


def _write_jax_checkpoint(directory, params, step=7, **extra):
    """A JAX training checkpoint as the JAX trainer writes it, with a fresh
    optax Adam state beside the params."""
    state = dict(params=params, opt_gen=optax.adam(1e-3).init(params), **extra)
    return save_checkpoint(state, str(directory), step, epoch=1)


@pytest.fixture(scope="module")
def svb(tmp_path_factory):
    """(JAX model, params, batch_stats, checkpoint directory)."""
    jm = jsvb.SVBVAE(dict_size=DICT_SIZE, hidden_size=32, latent_size=8, fvae_hidden=16,
                     fvae_kernel=5, fvae_enc_layers=2, fvae_dec_layers=2,
                     mel_strides=(2, 1, 1), asr_enc_layers=1, asr_dec_layers=1,
                     variant="mle")
    inputs = tuple(a.astype(np.int32) if a.dtype == np.int64 else a for a in svbvae_inputs())
    v = jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
                 "dropout": jax.random.PRNGKey(2)}, *inputs,
                concurrent_ways=("a2a", "p2p", "a2p"))
    rng = np.random.RandomState(0)
    params = _noisy(v["params"], rng, 0.05)
    stats = jax.tree_util.tree_map(lambda x: np.abs(np.asarray(x) + 0.2 * rng.randn(
        *np.shape(x))).astype(np.float32), v["batch_stats"])
    d = tmp_path_factory.mktemp("svb_jax_ckpt")
    _write_jax_checkpoint(d, params, batch_stats=stats)
    return jm, params, stats, str(d)


def _port_task():
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    task = SVBVAEMleTask()
    task.build_model()
    return task


def test_svb_checkpoint_restores_for_inference(svb, tmp_path):
    jm, params, stats, d = svb
    with hparams_scope(dict(SVB_HP, work_dir=d, binary_data_dir=str(tmp_path))):
        task = _port_task()
        assert task.restore() == 7
    want = svbvae_from_jax(params, stats)
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    inputs = svbvae_inputs()
    with torch.no_grad():
        rt = task.model(*[torch.tensor(a) for a in inputs], zero_noise=True)
    jin = tuple(a.astype(np.int32) if a.dtype == np.int64 else a for a in inputs)
    with jax_zero_noise():
        rj = jm.apply({"params": params, "batch_stats": stats}, *jin,
                      rngs={"noise": jax.random.PRNGKey(3)},
                      concurrent_ways=("a2a", "p2p", "a2p"))
    for way in ("a2a", "p2p"):
        agree(rt[way]["m_q"].transpose(1, 2), rj[way]["m_q"], 1e-5, f"{way} m_q")
        agree(rt[way]["mel_out"], rj[way]["mel_out"], 1e-5, f"{way} mel_out")
    agree(rt["a2p"]["mel_out"], rj["a2p"]["mel_out"], 1e-5, "a2p mel_out")


def test_svb_warm_start_and_asr_take_parameters_only(svb, tmp_path, capsys):
    _, params, stats, d = svb
    want = svbvae_from_jax(params, stats)
    with hparams_scope(dict(SVB_HP, work_dir="", binary_data_dir=str(tmp_path),
                            pretrain_asr_ckpt=d)):
        task = _port_task()
        init = {k: v.clone() for k, v in task.model.state_dict().items()}
        task.build_train()  # loads pretrain_asr_ckpt
        asr = dict(task.model.named_parameters())
        for k, v in task.model.state_dict().items():
            if k.startswith("vc_asr.") and k in asr:
                assert torch.equal(v, want[k]), k
            elif k.startswith("vc_asr."):  # BatchNorm statistics keep their init
                assert torch.equal(v, init[k]), k
            else:
                assert torch.equal(v, init[k]), k
        task.warm_start(d)
    out = capsys.readouterr().out
    assert "optimizers start fresh" in out and "Loaded the ASR's parameters" in out
    named = dict(task.model.named_parameters())
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, want[k] if k in named else init[k]), k


def test_resume_refuses_a_jax_checkpoint(svb):
    from neuralsvb_torch.training.checkpoint import get_last_checkpoint, load_checkpoint
    with pytest.raises(ValueError, match="load_ckpt"):
        load_checkpoint(get_last_checkpoint(svb[3]))


def _hifigan_dirs(root):
    """(JAX generator, params, {kind: vocoder dir}) for a params.msgpack
    directory and a JAX training-checkpoint directory of one generator."""
    jm = jhifigan.HifiGanGenerator(**GEN)
    v = jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                np.zeros((1, 8, 80), np.float32), np.zeros((1, 8), np.float32))
    params = _noisy(v["params"], np.random.RandomState(1), 0.05)
    cfg = {k: (list(map(list, v)) if k == "resblock_dilation_sizes" else
               list(v) if isinstance(v, tuple) else v) for k, v in GEN.items()}
    cfg["audio_num_mel_bins"] = cfg.pop("num_mels")
    dirs = {k: os.path.join(root, k) for k in ("msgpack", "ckpt")}
    for path in dirs.values():
        os.makedirs(path)
        with open(os.path.join(path, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    with open(os.path.join(dirs["msgpack"], "params.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(params))
    _write_jax_checkpoint(dirs["ckpt"], params, step=3)
    return jm, params, dirs


def _pwg_dirs(root):
    jm, params = jax_generator(ctx=2, seed=4)
    gp = dict(PWG_TINY, upsample_scales=list(PWG_TINY["upsample_scales"]),
              aux_context_window=2,
              upsample_params={"upsample_scales": list(PWG_TINY["upsample_scales"])})
    dirs = {k: os.path.join(root, k) for k in ("msgpack", "ckpt")}
    for path in dirs.values():
        os.makedirs(path)
        with open(os.path.join(path, "config.yaml"), "w") as f:
            yaml.safe_dump({"generator_params": gp}, f)
    with open(os.path.join(dirs["msgpack"], "params.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(params))
    _write_jax_checkpoint(dirs["ckpt"], params, step=3)
    return jm, params, dirs


def test_hifigan_reads_jax_files(tmp_path):
    from neuralsvb_tpu.vocoders.hifigan import HifiGAN as JHifiGAN
    from neuralsvb_torch.vocoders.hifigan import HifiGAN
    _, params, dirs = _hifigan_dirs(str(tmp_path))
    want = hifigan_from_jax(params)
    vocs = {k: HifiGAN({"vocoder_ckpt": d, "device": "cpu", "vocoder_denoise_c": 0.0})
            for k, d in dirs.items()}
    for voc in vocs.values():
        for k, v in voc.model.state_dict().items():
            assert torch.equal(v, want[k]), k
    rng = np.random.RandomState(4)
    mel = (rng.randn(40, 80) - 2).astype(np.float32)
    f0 = np.full(40, 22050 * 10 / 1024, np.float32)
    wav_t = vocs["msgpack"].spec2wav(mel, f0=f0, zero_noise=True)
    with jax_zero_noise():
        wav_j = JHifiGAN({"vocoder_ckpt": dirs["msgpack"], "vocoder_denoise_c": 0.0}).spec2wav(
            mel, f0=f0)
    assert wav_t.shape == (40 * 128,)
    agree(wav_t, wav_j, 1e-5, "HiFiGAN from params.msgpack")


def test_pwg_reads_jax_files(tmp_path, monkeypatch):
    from neuralsvb_tpu.vocoders.pwg import PWG as JPWG
    from neuralsvb_torch.vocoders.pwg import PWG
    _, params, dirs = _pwg_dirs(str(tmp_path))
    want = pwg_from_jax(params)
    vocs = {k: PWG({"vocoder_ckpt": d, "device": "cpu"}) for k, d in dirs.items()}
    for voc in vocs.values():
        for k, v in voc.model.state_dict().items():
            assert torch.equal(v, want[k]), k
    rng = np.random.RandomState(5)
    mel = (rng.randn(40, 80) - 2).astype(np.float32)
    z = rng.randn(1, 1, 128 * HOP).astype(np.float32)
    wav_t = vocs["msgpack"].spec2wav(mel, z=torch.tensor(z))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z).reshape(shape))
    wav_j = JPWG({"vocoder_ckpt": dirs["msgpack"]}).spec2wav(mel)
    agree(wav_t, wav_j, 1e-5, "PWG from params.msgpack")


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("kind", ["svb_checkpoint", "hifigan_params", "pwg_checkpoint"])
def test_decoders_agree(kind, svb, tmp_path):
    """The port's decoder and flax's ``msgpack_restore`` give the same leaves."""
    if kind == "svb_checkpoint":
        from neuralsvb_tpu.training.checkpoint import get_last_checkpoint
        path = get_last_checkpoint(svb[3])
    elif kind == "hifigan_params":
        path = os.path.join(_hifigan_dirs(str(tmp_path))[2]["msgpack"], "params.msgpack")
    else:
        from neuralsvb_tpu.training.checkpoint import get_last_checkpoint
        path = get_last_checkpoint(_pwg_dirs(str(tmp_path))[2]["ckpt"])
    with open(path, "rb") as f:
        data = f.read()
    got = msgpack_ckpt.restore(data)
    ref = serialization.msgpack_restore(data)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert leaves and len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path_, leaf in leaves:
        node = got
        for key in path_:
            node = node[key.key]
        assert _same(np.asarray(leaf) if isinstance(leaf, np.ndarray) else leaf, node), path_


def test_bfloat16_and_chunked_leaves_bit_exact(monkeypatch):
    """flax writes a bfloat16 leaf under the dtype name ``bfloat16`` and
    splits an array above ``MAX_CHUNK_SIZE`` bytes into chunks (here the
    limit is lowered to 64 bytes, so a small array takes that path)."""
    rng = np.random.RandomState(6)
    bf = jnp.asarray(rng.randn(3, 5), jnp.bfloat16)
    big = rng.randn(7, 9).astype(np.float32)
    tree = {"a": {"bf16": bf, "big": big, "small": np.arange(3, dtype=np.int16)},
            "bf_big": jnp.asarray(rng.randn(40), jnp.bfloat16), "step": 12, "best": None}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data and b"bfloat16" in data
    got = msgpack_ckpt.restore(data)
    for key, want in (("bf16", bf), ("big", big)):
        leaf = got["a"][key]
        if key == "bf16":
            assert leaf.dtype == torch.bfloat16 and leaf.shape == (3, 5)
            assert np.array_equal(leaf.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want).view(np.uint16))
        else:
            assert leaf.dtype == np.float32 and np.array_equal(leaf, want)
    assert got["bf_big"].dtype == torch.bfloat16 and np.array_equal(
        got["bf_big"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(tree["bf_big"]).view(np.uint16))
    assert got["step"] == 12 and got["best"] is None
    assert got["a"]["small"].dtype == np.int16
    with pytest.raises(ValueError):
        msgpack_ckpt.restore(data[:-5])
    with pytest.raises(ValueError):
        msgpack_ckpt.restore(data + b"\x00")


def test_smoke_encoder_reads_back_through_flax(tmp_path):
    """``chip_smoke.flax_msgpack_bytes`` of ``chip_smoke.hifigan_jax_tree``:
    flax's ``msgpack_restore`` gives the tree back exactly, ``from_bytes``
    fits it to the JAX generator's params, and ``hifigan_from_jax`` maps it
    back to the port's state_dict."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuralsvb_torch.models.hifigan import HifiGanGenerator
    torch.manual_seed(0)
    sd = HifiGanGenerator(**GEN).state_dict()
    tree = chip_smoke.hifigan_jax_tree(sd)
    data = chip_smoke.flax_msgpack_bytes(tree)
    back = serialization.msgpack_restore(data)
    assert chip_smoke._same_tree(tree, back)
    jm = jhifigan.HifiGanGenerator(**GEN)
    template = jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                       np.zeros((1, 8, 80), np.float32), np.zeros((1, 8), np.float32))
    serialization.from_bytes(template["params"], data)  # raises on another tree
    for k, v in hifigan_from_jax(back).items():
        assert torch.equal(v, sd[k]), k
    assert chip_smoke._same_tree(tree, msgpack_ckpt.restore(data))
