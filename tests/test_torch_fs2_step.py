"""One generator and one discriminator step of ``FastSpeech2AdvTask`` on the
PyTorch port vs the JAX package's, from identical weights (``fs2_from_jax``
+ ``disc_from_jax``) on one padded batch, at tiny widths of the
``egs/egs_bases/tts/fs2_adv.yaml`` recipe (hidden 32, one encoder and one
decoder layer, predictors 24 wide, disc hidden 8, windows 32/64), in two
configurations:

- ``frame``: the recipe's conv decoder and frame pitch, with energy, a
  speaker id and every loss weighted (``pdur``, ``sdur``, ``f0``, ``uv``,
  ``e``);
- ``cwt``: the FFT decoder, ``pitch_type: cwt`` with ``cwt_add_f0_loss``
  (``C``, ``uv``, ``f0_mean``, ``f0_std``, ``f0``) and a speaker embedding.

Nothing is drawn at random: every discriminator window starts at 0 and
every dropout mask keeps every element (the 1/(1-p) scaling stays). Checked
at the port's step tests' tolerances (``tests/test_torch_train_step.py``):
the losses (1e-4 relative), the gradients before clipping (per tensor
max|d| <= 1e-3 of its scale) and the parameters after each update.

The word-duration loss (``wdur``, with ``ph2word`` in the batch) is held
against the JAX task's ``_dur_loss`` run eagerly: inside the JAX package's
jitted step it raises, as ``n_words = int(ph2word.max()) + 1`` needs a
concrete value (``neuralsvb_tpu/tasks/fs2.py:127``; the JAX task's
``FastSpeechDataset`` never gives ``ph2word``, so its recipes do not reach
it). The port reads that count on the host.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import jax_zero_noise  # noqa: E402
from tests.test_torch_train_step import _capture, _check_grads, _check_losses  # noqa: E402
from tests.test_torch_vcppg_step import _check_state  # noqa: E402

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import disc_from_jax, fs2_from_jax  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, load_config_recursive  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=32, enc_layers=1, dec_layers=1, enc_ffn_kernel_size=5,
            dec_ffn_kernel_size=5, predictor_hidden=24, predictor_layers=2,
            mel_disc_hidden_size=8, disc_win_num=2, mesh_shape="data:1", device="cpu",
            f0_mean=200.0, f0_std=30.0, seed=1234, max_frames=5000, warmup_updates=2)
CONFIGS = {
    "frame": dict(use_energy_embed=True, use_spk_id=True, num_spk=5, lambda_ph_dur=0.3,
                  lambda_f0=0.5, lambda_energy=0.2),
    "cwt": dict(decoder_type="fft", pitch_type="cwt", cwt_add_f0_loss=True, lambda_f0=1.0,
                use_spk_id=False, use_spk_embed=True, cwt_hidden_size=16),
}
B, T, L, N_PHONES = 3, 72, 9, 30
LENS, TOK_LENS = (72, 60, 50), (9, 7, 6)
STEP = 1


@pytest.fixture(scope="module")
def bin_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fs2_bin")
    (d / "phone_set.json").write_text("[" + ",".join(f'"p{i}"' for i in range(N_PHONES)) + "]")
    return d


def _hp(bin_dir, config):
    cfg = load_config_recursive(os.path.join(REPO, "egs/egs_bases/tts/fs2_adv.yaml"))
    return dict(cfg, **TINY, **CONFIGS[config], binary_data_dir=str(bin_dir))


def _batch(seed=3, with_ph2word=False):
    from neuralsvb_torch.ops import cwt
    from neuralsvb_torch.ops.pitch_utils import norm_interp_f0
    rng = np.random.RandomState(seed)
    hp = {"pitch_norm": "standard", "f0_mean": 200.0, "f0_std": 30.0, "use_uv": True}
    m = np.arange(T)[None] < np.asarray(LENS)[:, None]
    tokens = np.zeros((B, L), np.int64)
    mel2ph, ph2word = np.zeros((B, T), np.int64), np.zeros((B, L), np.int64)
    f0s, uvs, specs, means, stds = [], [], [], [], []
    for b, (n, fl) in enumerate(zip(TOK_LENS, LENS)):
        tokens[b, :n] = rng.randint(4, N_PHONES + 4, n)
        mel2ph[b, :fl] = np.repeat(np.arange(1, n + 1), rng.multinomial(fl - n, np.ones(n) / n) + 1)
        ph2word[b, :n] = np.repeat(np.arange(1, n), 2)[:n] if n > 1 else 1
        f0 = 180 + 40 * np.sin(np.arange(T) / (3.0 + b)) * m[b]
        f0[fl:], f0[2:5] = 0, 0
        f0n, uv = norm_interp_f0(f0, hp)
        f0s.append(f0n * m[b])
        uvs.append(uv)
        _, lf0 = cwt.get_cont_lf0(f0[:fl])
        spec, _ = cwt.get_lf0_cwt((lf0 - lf0.mean()) / lf0.std())
        specs.append(np.pad(spec, ((0, T - fl), (0, 0))))
        means.append(lf0.mean())
        stds.append(lf0.std())
    mels = ((rng.randn(B, T, 80) - 2) * m[..., None]).astype(np.float32)
    return dict(id=np.arange(B), nsamples=B, txt_tokens=tokens, mels=mels, mel2ph=mel2ph,
                mel_lengths=np.asarray(LENS), f0=np.stack(f0s).astype(np.float32),
                uv=np.stack(uvs).astype(np.float32),
                energy=(np.sqrt((np.exp(mels) ** 2).sum(-1)) * m).astype(np.float32),
                cwt_spec=np.stack(specs).astype(np.float32),
                f0_mean=np.asarray(means, np.float32), f0_std=np.asarray(stds, np.float32),
                spk_ids=np.asarray([0, 2, 4]), spk_embed=rng.randn(B, 256).astype(np.float32),
                **({"ph2word": ph2word} if with_ph2word else {}))


@pytest.fixture
def patched(monkeypatch):
    """All-keep dropout on both sides; window starts at 0 on the JAX side."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    with jax_zero_noise():
        yield


def _jax_task(hp):
    from neuralsvb_tpu.tasks.fs2_adv import FastSpeech2AdvTask
    jhparams.clear()
    jhparams.update(hp)
    task = FastSpeech2AdvTask()
    task.build_model()
    task.tx_gen = optax.chain(_capture(), task.tx_gen)
    task.tx_disc = optax.chain(_capture(), task.tx_disc)
    st = jax.device_get(task.state)
    st["opt_gen"] = task.tx_gen.init(st["params"])
    st["opt_disc"] = task.tx_disc.init(st["disc_params"])
    task.set_state(st)
    return task, jax.device_get(st)


def _torch_names(params, disc_params, disc_stats):
    out = {k: v.numpy() for k, v in fs2_from_jax(params).items()}
    out.update({f"disc.{k}": v.numpy() for k, v in disc_from_jax(disc_params,
                                                                 disc_stats).items()})
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_adv_steps_match_jax(bin_dir, patched, config):
    hp = _hp(bin_dir, config)
    batch = _batch()
    saved = dict(jhparams)
    try:
        jtask, st0 = _jax_task(hp)
        j_gen = jtask.training_step(batch, STEP, 0)
        j_disc = jtask.training_step(batch, STEP, 1)
        st = jax.device_get(jtask.state)
    finally:
        jhparams.clear()
        jhparams.update(saved)
    with hparams_scope(dict(hp)):
        from neuralsvb_torch.tasks.fs2_adv import FastSpeech2AdvTask
        task = FastSpeech2AdvTask()
        task.build_model()
        task.build_train()
        task.model.load_state_dict(fs2_from_jax(st0["params"]))
        task.mel_disc.load_state_dict(disc_from_jax(st0["disc_params"][""],
                                                    st0["disc_batch_stats"][""]))
        task.disc_start_frames_wins = [0, 0]
        grads = {}
        task.grad_hook = lambda group, params: grads.__setitem__(
            group, [p.grad.detach().clone() for p in params])
        names = {"gen": [n for n, _ in task.model.named_parameters()],
                 "disc": [f"disc.{n}" for n, _ in task.mel_disc.named_parameters()]}
        t_gen = task.training_step(batch, STEP, 0)
        t_disc = task.training_step(batch, STEP, 1)
    _check_losses(t_gen[1], j_gen[1], "gen")
    _check_losses(t_disc[1], j_disc[1], "disc")
    want_keys = ({"pdur", "sdur", "f0", "uv", "e", "a"} if config == "frame"
                 else {"pdur", "sdur", "C", "uv", "f0_mean", "f0_std", "f0", "a"})
    assert want_keys <= set(t_gen[1]) and {"r", "f"} <= set(t_disc[1])
    want = _torch_names(st["opt_gen"][0]["g"], st["opt_disc"][0]["g"][""],
                        st0["disc_batch_stats"][""])
    settled = _check_grads(grads["gen"], want, names["gen"], "gen")
    settled.update(_check_grads(grads["disc"], want, names["disc"], "disc"))
    assert float(grads["gen"][names["gen"].index("encoder.embed_tokens.weight")]
                 .abs().max()) > 0
    _check_state(task, _torch_names(st["params"], st["disc_params"][""],
                                    st["disc_batch_stats"][""]),
                 max(j_gen[1]["lr_0"], j_disc[1]["lr_1"]), settled, "after gen+disc")


def test_word_duration_loss_matches_jax(bin_dir):
    """``pdur``, ``sdur`` and ``wdur`` of the same predicted durations, the
    port's against the JAX task's ``_dur_loss`` outside ``jit``."""
    hp = _hp(bin_dir, "frame")
    batch = _batch(with_ph2word=True)
    dur = np.random.RandomState(7).randn(B, L).astype(np.float32)
    saved = dict(jhparams)
    try:
        jhparams.clear()
        jhparams.update(hp)
        from neuralsvb_tpu.tasks.fs2 import FastSpeech2Task as J
        want = {}
        J._dur_loss(None, {"dur": jnp.asarray(dur)},
                    {k: jnp.asarray(batch[k]) for k in ("txt_tokens", "mel2ph", "ph2word")},
                    want)
    finally:
        jhparams.clear()
        jhparams.update(saved)
    with hparams_scope(dict(hp)):
        from neuralsvb_torch.tasks.fs2 import FastSpeech2Task as Tt
        got = {}
        Tt._dur_loss(None, {"dur": torch.as_tensor(dur)},
                     {k: torch.as_tensor(batch[k]) for k in ("txt_tokens", "mel2ph", "ph2word")},
                     got)
    assert set(got) == set(want) == {"pdur", "sdur", "wdur"}
    _check_losses(got, want, "dur")


def test_jax_jitted_step_fails_on_ph2word(bin_dir):
    """The JAX package's fault that the port does not share."""
    hp = _hp(bin_dir, "frame")
    saved = dict(jhparams)
    try:
        jtask, _ = _jax_task(hp)
        with pytest.raises(jax.errors.ConcretizationTypeError):
            jtask.training_step(_batch(with_ph2word=True), STEP, 0)
    finally:
        jhparams.clear()
        jhparams.update(saved)


def test_restores_a_jax_checkpoint(bin_dir, tmp_path):
    """A JAX ``FastSpeech2AdvTask`` checkpoint (``save_checkpoint``'s
    msgpack) in the work dir: the port's ``--infer`` restore loads its
    parameters through ``fs2_from_jax``, and ``load_ckpt`` warm-starts them."""
    from neuralsvb_tpu.training.checkpoint import save_checkpoint
    hp = _hp(bin_dir, "cwt")
    saved = dict(jhparams)
    try:
        jtask, st0 = _jax_task(hp)
    finally:
        jhparams.clear()
        jhparams.update(saved)
    save_checkpoint(st0, str(tmp_path / "jax"), 7, epoch=1)
    want = fs2_from_jax(st0["params"])
    from neuralsvb_torch.tasks.fs2_adv import FastSpeech2AdvTask
    with hparams_scope(dict(hp, work_dir=str(tmp_path / "jax"))):
        task = FastSpeech2AdvTask()
        task.build_model()
        assert task.restore() == 7
    with hparams_scope(dict(hp, work_dir=str(tmp_path / "port"))):
        warm = FastSpeech2AdvTask()
        warm.build_model()
        warm.warm_start(str(tmp_path / "jax"))
    for m in (task.model, warm.model):
        got = m.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
