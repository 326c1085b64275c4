"""``compute_dtype: bfloat16`` on the port against the JAX package's bf16
(JAX tests: ``tests/test_bf16.py``, marked slow there).

- The flagship's forward (a2a, p2p, a2p ``mel_out``, eval mode, zero
  noise) with ``compute_dtype: bfloat16``: the port's cast at the apply
  boundary (``tasks/base_task.py`` ``apply_in_dtype``) against the JAX
  task's ``_apply_model``, from identical weights. Two bf16 computations
  round at different places and in different orders, so the bound is the
  bf16 rounding itself, r = mean|jax_bf16 - f32| (f32: the port's float32
  forward, which ``tests/test_torch_svb_vae.py`` holds to JAX's within
  1e-4): mean|port_bf16 - jax_bf16| at most r and mean|port_bf16 - f32| at
  most 2 r (measured: 0.78 r and 1.25 r), and max|port - jax_bf16| at most 0.03 (measured 0.014; the JAX
  package's own bar for bf16 against float32 is a mean of 0.05). The norms
  compute their statistics in float32, as flax's do: with bf16 statistics
  the map step's gradient (BatchNorm over 4 latents) had cosine 0.27 to the
  float32 one, against 0.998 now and 0.999 for the JAX package's. The body
  really runs in bf16: the decoder's output conv sees and returns bf16.
- A bf16 gen + disc step and a map step: parameters, optimizer states and
  BatchNorm statistics stay float32, and so do the losses.
- The HiFiGAN vocoder with ``vocoder_compute_dtype: bfloat16``: the wav
  against the JAX bf16 vocoder from the same checkpoint, bounded the same
  way against the JAX bf16 vocoder's distance to its float32 one (mean at
  most that distance, max at most 2x it), and every activation after the
  NSF injection is bf16 (the JAX regression
  ``test_hifigan_bf16_stays_bf16_past_nsf_injection``), the ResBlock
  cluster's input included. ``compute_dtype`` is the fallback.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests import test_torch_hifigan as th  # noqa: E402
from tests import test_torch_train_step as svb_step  # noqa: E402
from tests.test_torch_support import jax_zero_noise, one_torch_thread  # noqa: E402,F401

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import disc_from_jax, svbvae_mle_from_jax  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WAYS = ("a2a", "p2p", "a2p")
HP = dict(svb_step.HP, zero_noise=True)


def _jax_forward(cdt):
    """The JAX flagship's eval forward in ``cdt``; returns (outputs, state)."""
    from neuralsvb_tpu.tasks.svb_vae_task import SVBVAEMleTask
    jhparams.clear()
    jhparams.update(dict(HP, compute_dtype=cdt))
    task = SVBVAEMleTask()
    task.build_model()
    b = task._prep_batch_host(svb_step._batch(), infer=True)
    with jax_zero_noise():
        out = task._apply_model(task.state["params"], task.state["batch_stats"], b, WAYS,
                                jax.random.PRNGKey(0), train=False)
    return {w: np.asarray(out[w]["mel_out"]) for w in WAYS}, jax.device_get(task.state)


def _port_task(st):
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    task = SVBVAEMleTask()
    task.build_model()
    task.build_train()
    task.model.load_state_dict(svbvae_mle_from_jax(st["params"], st["batch_stats"]))
    task.mel_disc.load_state_dict(disc_from_jax(st["disc_params"], st["disc_batch_stats"]))
    return task


@pytest.fixture(scope="module")
def jax_outs():
    saved = dict(jhparams)
    try:
        bf16, st = _jax_forward("bfloat16")
    finally:
        jhparams.clear()
        jhparams.update(saved)
    return bf16, st


def test_bf16_forward_matches_jax(jax_outs):
    bf16, st = jax_outs
    with hparams_scope(dict(HP)):
        task = _port_task(st)
        task.model.eval()
        out32 = task.forward(task._prep_batch(svb_step._batch()))
    # the float32 forward: the port's equals the JAX package's within 1e-4
    # (tests/test_torch_svb_vae.py), so it stands in for JAX's here
    f32 = {w: out32[w]["mel_out"].numpy() for w in WAYS}
    with hparams_scope(dict(HP, compute_dtype="bfloat16")):
        task = _port_task(st)
        seen = []
        conv = task.model.vae_model.decoder.out_proj
        conv.register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
        task.model.eval()
        out = task.forward(task._prep_batch(svb_step._batch()))
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen), seen
    for w in WAYS:
        got = out[w]["mel_out"]
        assert got.dtype == torch.float32
        d = np.abs(got.numpy() - bf16[w])
        rounding = float(np.abs(bf16[w] - f32[w]).mean())
        to_f32 = float(np.abs(got.numpy() - f32[w]).mean())
        assert rounding > 0
        assert float(d.mean()) <= rounding, (w, float(d.mean()), rounding)
        assert to_f32 <= 2 * rounding, (w, to_f32, rounding)
        assert float(d.max()) <= 0.03, (w, float(d.max()))


def _map_grads(st, cdt):
    with hparams_scope(dict(HP, compute_dtype=cdt)):
        task = _port_task(st)
        grads = {}
        task.grad_hook = lambda group, ps: grads.__setitem__(group, [p.grad.clone() for p in ps])
        task.training_step(svb_step._batch(), 101, 2)
    return grads["map"]


def test_bf16_steps_keep_float32_state(jax_outs):
    """Parameters, optimizer states, BatchNorm statistics and losses stay
    float32 through a bf16 gen + disc step and a map step; the model and
    the BatchNorm statistics moved. The map step's gradient keeps the
    float32 one's direction (cosine >= 0.99; the JAX package's bf16 map
    gradient has 0.999 to its float32 one): its BatchNorms normalize over
    the batch's few latents, which bf16 statistics would wreck."""
    _, st = jax_outs
    with hparams_scope(dict(HP, compute_dtype="bfloat16")):
        task = _port_task(st)
        task.disc_start_frames_wins = [0, 0]
        before = {k: v.clone() for k, v in task.model.state_dict().items()}
        logs = {}
        for step, idx in ((1, 0), (1, 1), (101, 2)):
            total, out = task.training_step(svb_step._batch(), step, idx)
            assert total.dtype == torch.float32
            logs.update(out)
    g16, g32 = _map_grads(st, "bfloat16"), _map_grads(st, "")
    dot = sum(float((a * b).sum()) for a, b in zip(g16, g32))
    cos = dot / (sum(float((a * a).sum()) for a in g16)
                 * sum(float((b * b).sum()) for b in g32)) ** 0.5
    assert cos >= 0.99, cos
    assert {"a2a_kl", "l1p2p", "a2a_r", "a2p_mle"} <= set(logs)
    for k, v in logs.items():
        if torch.is_tensor(v):
            assert v.dtype == torch.float32 and torch.isfinite(v), k
    for m in (task.model, task.mel_disc):
        for k, v in m.state_dict().items():
            assert v.dtype in (torch.float32, torch.int64), (k, v.dtype)
    for opt in (task.opt_gen, task.opt_disc, task.opt_map):
        assert opt.state
        for s in opt.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    after = task.model.state_dict()
    assert not torch.equal(after["vae_model.decoder.out_proj.weight"],
                           before["vae_model.decoder.out_proj.weight"])
    assert any("running" in k and not torch.equal(v, before[k]) for k, v in after.items())


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    import yaml
    d = tmp_path_factory.mktemp("bf16_voc")
    th._generator_and_params(d)
    cfg = {k: list(v) if isinstance(v, tuple) else v for k, v in th.GEN.items()}
    cfg["resblock_dilation_sizes"] = [list(x) for x in th.GEN["resblock_dilation_sizes"]]
    (d / "config.yaml").write_text(yaml.safe_dump(cfg))
    return {"vocoder_ckpt": str(d), "audio_sample_rate": th.SR, "audio_num_mel_bins": 80,
            "vocoder_denoise_c": 0.0, "device": "cpu"}


def _voc_inputs():
    rng = np.random.RandomState(4)
    return (rng.randn(40, 80) - 2).astype(np.float32), th._f0(1, 40)[0]


@pytest.fixture(scope="module")
def jax_wavs(voc_dir):
    """The JAX vocoder's wav in bf16 and in float32."""
    from neuralsvb_tpu.vocoders.hifigan import HifiGAN as JHifiGAN
    mel, f0 = _voc_inputs()
    with jax_zero_noise():
        return (np.asarray(JHifiGAN(dict(voc_dir, vocoder_compute_dtype="bfloat16"))
                           .spec2wav(mel, f0=f0)),
                np.asarray(JHifiGAN(dict(voc_dir)).spec2wav(mel, f0=f0)))


@pytest.mark.parametrize("key", ["vocoder_compute_dtype", "compute_dtype"])
def test_bf16_vocoder_matches_jax(voc_dir, jax_wavs, key):
    from neuralsvb_torch.models import hifigan as thifigan
    from neuralsvb_torch.vocoders.hifigan import HifiGAN as THifiGAN
    mel, f0 = _voc_inputs()
    hp = dict(voc_dir, **{key: "bfloat16"})
    voc = THifiGAN(dict(hp))
    assert voc.model.conv_pre.weight.dtype == torch.bfloat16
    seen = {}
    for i, (up, nc) in enumerate(zip(voc.model.ups, voc.model.noise_convs)):
        up.register_forward_hook(lambda m, a, o, i=i: seen.__setitem__(f"up_{i}", o.dtype))
        nc.register_forward_hook(lambda m, a, o, i=i: seen.__setitem__(f"noise_{i}", o.dtype))
    cluster = thifigan.fused_resblock_cluster

    def spy(x, *a, **kw):
        seen.setdefault("cluster_in", set()).add(x.dtype)
        y = cluster(x, *a, **kw)
        seen.setdefault("cluster_out", set()).add(y.dtype)
        return y
    thifigan.fused_resblock_cluster = spy
    try:
        wav_t = voc.spec2wav(mel, f0=f0, zero_noise=True)
    finally:
        thifigan.fused_resblock_cluster = cluster
    assert wav_t.dtype == torch.float32 and wav_t.shape == (40 * 16,)
    assert all(v == torch.bfloat16 for k, v in seen.items() if not k.startswith("cluster"))
    assert seen["cluster_in"] == seen["cluster_out"] == {torch.bfloat16}
    wav_j, wav_j32 = jax_wavs
    d = np.abs(wav_t.numpy() - wav_j)
    rounding = np.abs(wav_j - wav_j32)
    assert float(rounding.mean()) > 0
    assert float(d.mean()) <= float(rounding.mean()), (float(d.mean()), float(rounding.mean()))
    assert float(d.max()) <= 2 * float(rounding.max()), (float(d.max()), float(rounding.max()))
