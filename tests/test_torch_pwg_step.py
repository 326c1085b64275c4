"""Parallel WaveGAN training on the PyTorch port against the JAX package's
``PWGTask`` (``neuralsvb_tpu/tasks/vocoder_task.py``):

- ``training/optim.py`` ``RAdam`` against ``optax.scale_by_radam`` over 12
  steps at gradient scales 1 and 1e-7: each parameter's change from its
  start within 1e-5 of the largest. Steps 1-5 take the unrectified
  ``m_hat`` on both sides; from step 6 the rectified update runs, and at
  scale 1e-7 ``sqrt(v_hat)`` is comparable to eps, where
  ``torch.optim.RAdam``'s eps placement gives an update about half of
  optax's: it fails the same check;
- one generator step and one discriminator step of ``PWGTask`` on the same
  batch and injected noise ``z``, at the widths of the JAX package's PWG
  task test (``tests/test_tasks2.py``), at ``test_torch_train_step.py``'s
  gates: losses 1e-4 relative, each gradient before clipping within 1e-3
  of its tensor's scale, and the parameters after the step;
- the recipe's CLI (``pwg_torch.yaml``) on the CPU: 8 steps with the
  discriminator from step 2, a resume to 10, then ``PWG.spec2wav`` serving
  the checkpoint."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
yaml = pytest.importorskip("yaml")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_vocoder_step import _capture, _scales, write_vocoder_split  # noqa: E402

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import pwg_disc_from_jax, pwg_from_jax  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402
from neuralsvb_torch.training.optim import RAdam  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "egs/egs_bases/tts/vocoder/pwg_torch.yaml")
HOP = 128
GEN = {"layers": 4, "stacks": 2, "residual_channels": 8, "gate_channels": 16,
       "skip_channels": 8, "upsample_scales": [4, 4, 8]}
HP = dict(audio_sample_rate=22050, fft_size=512, hop_size=HOP, win_size=512,
          audio_num_mel_bins=80, generator_params=GEN, aux_context_window=2,
          max_samples=2048, max_sentences=2, lambda_adv=4.0, disc_start_steps=0,
          generator_grad_norm=10, discriminator_grad_norm=1,
          stft_loss_scales=[[1024, 120, 600], [2048, 240, 1200], [512, 50, 240]],
          seed=1234, train_set_name="train", valid_set_name="valid", endless_ds=True,
          ds_workers=0, mesh_shape="data:1", device="cpu")
STEP = 5


def _radam_run(make_port, scale, steps=12, lr=1e-3):
    """(port's change, optax's change) of three parameters over ``steps``
    steps of seeded gradients times ``scale``. The parameters start at 0
    (the update does not read them), so float32 holds each change to its
    own precision, not to that of a parameter of order 1."""
    rng = np.random.RandomState(0)
    p0 = [np.zeros(s, np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    grads = [[(scale * rng.randn(*p.shape)).astype(np.float32) for p in p0]
             for _ in range(steps)]
    params = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = make_port(params, lr)
    tx = optax.chain(optax.scale_by_radam(b1=0.9, b2=0.999), optax.scale(-lr))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)  # as the JAX task runs it (b2^t is a pow under jit)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.tensor(gi)
        opt.step()
        upd, state = update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, upd)
    port = np.concatenate([(p.detach().numpy() - a).ravel() for p, a in zip(params, p0)])
    want = np.concatenate([(np.asarray(p) - a).ravel() for p, a in zip(jp, p0)])
    return port, want


def _rel(port, want):
    return float(np.abs(port - want).max() / np.abs(want).max())


@pytest.mark.parametrize("scale", [1.0, 1e-7])
def test_radam_matches_optax(scale):
    port, want = _radam_run(lambda ps, lr: RAdam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8),
                            scale)
    assert _rel(port, want) <= 1e-5, _rel(port, want)


def test_torch_radam_is_not_optax_radam():
    """The same check on ``torch.optim.RAdam``: at scale 1e-7 its eps sits
    on ``sqrt(v_hat)`` scaled by ``1 / sqrt(1 - b2^t)`` and the parameters
    move by roughly half of what optax moves them."""
    def make(ps, lr):
        return torch.optim.RAdam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    port, want = _radam_run(make, 1e-7)
    assert _rel(port, want) > 0.2, _rel(port, want)
    port1, want1 = _radam_run(make, 1.0)
    assert _rel(port1, want1) <= 1e-3  # at scale 1 eps is negligible either way


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pwg_data")
    write_vocoder_split(str(root), (10, 40, 16, 23, 64, 12), "train", 1)
    write_vocoder_split(str(root), (10, 40, 16), "valid", 2)
    return str(root)


def _torch_names(gen, disc):
    out = {f"gen.{k}": v.numpy() for k, v in pwg_from_jax(gen).items()}
    out.update({f"disc.{k}": v.numpy() for k, v in pwg_disc_from_jax(disc).items()})
    return out


def test_steps_match_jax(data, monkeypatch):
    from neuralsvb_tpu.tasks.vocoder_task import PWGTask as JTask
    from neuralsvb_torch.tasks.vocoder_task import PWGTask as TTask
    from neuralsvb_torch.tasks.vocoder_task import VocoderDataset
    hp = dict(HP, binary_data_dir=data)
    jhparams.clear()
    jhparams.update(hp)
    jtask = JTask()
    jtask.build_model()
    jtask.tx_gen = optax.chain(_capture(), jtask.tx_gen)
    jtask.tx_disc = optax.chain(_capture(), jtask.tx_disc)
    st0 = jax.device_get(jtask.state)
    st0["opt_gen"] = jtask.tx_gen.init(st0["params"])
    st0["opt_disc"] = jtask.tx_disc.init(st0["disc"])
    jtask.set_state(st0)

    with hparams_scope(hp):
        ds = VocoderDataset("train")
        batch = ds.collater([ds[1], ds[4]])  # two random crops of 16 frames
        z = np.random.RandomState(6).randn(2, 1, 2048).astype(np.float32)
        task = TTask()
        task.build_model()
        task.build_train()
        task.model.load_state_dict(pwg_from_jax(st0["params"]))
        task.disc.load_state_dict(pwg_disc_from_jax(st0["disc"]))
        task.noise = lambda wavs, generator: torch.tensor(z)
        grads = {}
        task.grad_hook = lambda name, params: grads.__setitem__(
            name, [p.grad.detach().clone() for p in params])
        t_gen = task.training_step(batch, STEP, 0)
        t_disc = task.training_step(batch, STEP, 1)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z).reshape(shape))
    j_gen = jtask.training_step(batch, STEP, 0)
    j_disc = jtask.training_step(batch, STEP, 1)
    st = jax.device_get(jtask.state)

    for (_, got), (_, want) in ((t_gen, j_gen), (t_disc, j_disc)):
        got = {k: float(torch.as_tensor(v).detach()) for k, v in got.items()
               if not k.startswith("lr_")}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)
    assert set(t_gen[1]) == {"sc", "mag", "a", "lr_0"} and set(t_disc[1]) == {"r", "f", "lr_1"}

    names = {"gen": [f"gen.{n}" for n, _ in task.model.named_parameters()],
             "disc": [f"disc.{n}" for n, _ in task.disc.named_parameters()]}
    want = _torch_names(st["opt_gen"][0]["g"], st["opt_disc"][0]["g"])
    for group in ("gen", "disc"):
        scales = _scales(want, names[group])
        for n, g in zip(names[group], grads[group]):
            d = float(np.abs(g.numpy() - want[n]).max())
            assert d <= 1e-3 * scales[n], f"{n}: max|d| {d:.3e} vs scale {scales[n]:.3e}"

    # RAdam's first step is unrectified: each parameter moves by lr times its
    # clipped gradient, so the parameters after it differ by lr times the
    # gradients' difference (and the float32 rounding of the sum)
    after = _torch_names(st["params"], st["disc"])
    port = {f"gen.{k}": v.numpy() for k, v in task.model.state_dict().items()}
    port.update({f"disc.{k}": v.numpy() for k, v in task.disc.state_dict().items()})
    lr = {"gen": float(t_gen[1]["lr_0"]), "disc": float(t_disc[1]["lr_1"])}
    for k, v in port.items():
        group = k.split(".")[0]
        scale = _scales(want, names[group])[k]
        tol = 2e-3 * lr[group] * scale + 1e-6 * max(1.0, float(np.abs(after[k]).max()))
        assert float(np.abs(v - after[k]).max()) <= tol, k


CLI_HP = dict(HP, generator_params=dict(GEN, aux_context_window=2,
                                        upsample_params={"upsample_scales": [4, 4, 8]}),
              disc_start_steps=1, max_updates=8, val_check_interval=4, num_sanity_val_steps=1,
              tb_log_interval=1, num_ckpt_keep=2)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("pwg_e2e")
    data = root / "data"
    write_vocoder_split(str(data), (20, 6, 12), "train", 3)
    write_vocoder_split(str(data), (9, 18), "valid", 4)
    hp = {k: v for k, v in CLI_HP.items() if k not in ("device", "mesh_shape")}
    (root / "cfg.yaml").write_text(yaml.safe_dump(
        dict(hp, base_config=[RECIPE], binary_data_dir=str(data))))

    def cli(extra=""):
        out = subprocess.run(
            [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config",
             str(root / "cfg.yaml"), "--hparams", f"device=cpu,work_dir={root / 'work'}{extra}"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
            timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        return out.stdout

    first = cli()
    c8 = torch.load(root / "work" / "model_ckpt_steps_8.ckpt", weights_only=True)
    c4 = torch.load(root / "work" / "model_ckpt_steps_4.ckpt", weights_only=True)
    resumed = cli(",max_updates=10")
    return root, first, resumed, c4, c8


def _steps(stdout):
    return {int(m.group(1)): json.loads(m.group(2))
            for m in re.finditer(r"^\| step (\d+): (\{.*\})$", stdout, re.M)}


def test_cli_trains_resumes_and_serves(cli_run):
    root, first, resumed, c4, c8 = cli_run
    steps = _steps(first)
    assert sorted(steps) == list(range(1, 9))
    gen, disc = {"sc", "mag", "a", "lr_0"}, {"r", "f", "lr_1"}
    for n, logs in steps.items():  # "step n" logs step n - 1; steps 0, 1 <= disc_start_steps
        assert gen <= set(logs) and (disc <= set(logs)) == (n > 2), (n, logs)
        assert all(np.isfinite(v) for v in logs.values())
    assert first.count("| Valid results:") == 3  # sanity at 0, then steps 4 and 8
    assert "'sc'" in first and "'mag'" in first
    # both optimizers took their rectified steps (count 6 and more) by step 8
    for i, n in ((0, 8), (1, 6)):
        counts = {st["step"] for st in c8["optimizer_states"][i]["state"].values()}
        assert counts == {n}, (i, counts)
    for key in ("model_gen", "disc"):
        assert any(not torch.equal(c4["state_dict"][key][k], v)
                   for k, v in c8["state_dict"][key].items()), key
    assert "| Restored ckpt:" in resumed and sorted(_steps(resumed)) == [9, 10]
    summary = json.loads(re.search(r"^\| train summary: (\{.*\})$", resumed, re.M).group(1))
    assert summary["start_step"] == 8 and summary["end_step"] == 10

    from neuralsvb_torch.vocoders.pwg import PWG
    c10 = torch.load(root / "work" / "model_ckpt_steps_10.ckpt", weights_only=True)
    voc = PWG({"vocoder_ckpt": str(root / "work"), "device": "cpu"})
    for k, v in voc.model.state_dict().items():
        assert torch.equal(v, c10["state_dict"]["model_gen"][k]), k
    mel = (np.random.RandomState(2).randn(30, 80) - 4).astype(np.float32)
    wav = voc.spec2wav(mel)
    assert wav.shape == (30 * HOP,) and torch.isfinite(wav).all() and wav.abs().max() > 0
