"""ASR pre-training end to end on the CPU at tiny widths, and its checkpoint
warm-starting the flagship's frozen PPG extractor in both packages.

A synthetic speech corpus (``write_synthetic_speech_corpus``: 2 speakers x
3 utterances of 1.0-1.3 s, random English sentences in a ``text_labels/``
mirror of ``data/``) goes through
``python -m neuralsvb_torch.data.binarize --config vc_ppg_torch.yaml``;
``python -m neuralsvb_torch.tasks.run`` trains ``VCPPGTask`` 3 steps
(discriminator from step 1, validating at 0 and 2) and resumes to 5.
Checked: the binarized items carry the phone tokens of ``phone_set.json``;
every logged loss is finite with the recipe's keys; the ASR changes (its
CE loss trains it) while its BatchNorm statistics do not; the resumed run
starts at step 3.

Then the port's flagship (``SVBVAEMleTask``) and the JAX package's, both
with ``pretrain_asr_ckpt`` at that work dir, hold the checkpoint's
``vc_asr`` parameters bit for bit (the decoder's keys skipped) and give the
same ``h_content`` within 1e-5.

Then the two faults of the JAX ``VCPPGTask`` on this path, beside the
port's explicit answer: ``test_step`` raises ``KeyError: 'multi_spk_emb'``
(the port's ``--infer`` raises NotImplementedError naming the JAX lines),
and ``validation_step`` with a logger at a ``valid_infer_interval`` step
raises ``KeyError: 'prof_f0'`` (the port renders nothing and returns the
same validation losses as the JAX ``forward_losses``, within 1e-4
relative). Last, ``SVBParaTask``'s ``--infer`` and validation rendering
through the registry's vocoder, in-process.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from tests.test_torch_train_step import HP as FLAGSHIP_HP  # noqa: E402

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import vcasr_from_jax, vcppg_from_jax  # noqa: E402
from neuralsvb_torch.data.synthetic import write_synthetic_speech_corpus  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, set_hparams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "egs/egs_bases/vc/vc_ppg_torch.yaml")
TINY = dict(hidden_size=32, asr_enc_layers=1, asr_dec_layers=1, dec_layers=2, ref_enc_out=32,
            mel_disc_hidden_size=8, disc_win_num=2, test_num=2, ds_workers=1,
            max_updates=3, val_check_interval=2, num_sanity_val_steps=1, tb_log_interval=1,
            num_valid_plots=1, valid_infer_interval=2, warmup_updates=2)
GEN_KEYS, DISC_KEYS = {"l1", "ssim", "asr", "a", "lr_0"}, {"r", "f", "lr_1"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vcppg_e2e")
    processed = str(root / "processed")
    write_synthetic_speech_corpus(processed, 2, 3, seconds=(1.0, 1.3))
    cfg = dict(TINY, base_config=[RECIPE], processed_data_dir=processed,
               binary_data_dir=str(root / "binary"))
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return root


def _cli(root, module, *args, hp=""):
    out = subprocess.run(
        [sys.executable, "-m", module, "--config", str(root / "cfg.yaml"), *args,
         "--hparams", f"device=cpu,work_dir={root / 'work'}{hp}"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _ckpt(root, step):
    return torch.load(root / "work" / f"model_ckpt_steps_{step}.ckpt", weights_only=True)


@pytest.fixture(scope="module")
def trained(root):
    binarized = _cli(root, "neuralsvb_torch.data.binarize")
    first = _cli(root, "neuralsvb_torch.tasks.run")
    c2 = _ckpt(root, 2)
    resumed = _cli(root, "neuralsvb_torch.tasks.run", hp=",max_updates=5")
    return binarized, first, resumed, c2


def _init_model(root):
    from neuralsvb_torch.tasks.vc_ppg import VCPPGTask
    hp = set_hparams(config=str(root / "cfg.yaml"), hparams_str="device=cpu",
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp):
        task = VCPPGTask()
        task.build_model()
        return task.model.state_dict()


def test_binarize_train_resume(root, trained):
    from neuralsvb_torch.data.indexed_dataset import IndexedDataset
    binarized, first, resumed, c2 = trained
    phones = json.loads((root / "binary" / "phone_set.json").read_text())
    assert f"| Build phone set. Size: {len(phones)}" in binarized
    items = [IndexedDataset(str(root / "binary" / "train"))[i] for i in range(4)]
    for it in items:
        ids = list(it["phone"])
        assert ids[0] == phones.index("<BOS>") + 4 and ids[-1] == phones.index("<EOS>") + 4
        assert it["ph"].split(" ") == [phones[i - 4] for i in ids]
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", first + resumed, re.M)}
    assert sorted(steps) == [1, 2, 3, 4, 5]
    for n, logs in steps.items():  # "step n" logs step n - 1; the disc from step 1
        keys = set(logs) - {"total_loss_0", "total_loss_1"}
        assert keys == (GEN_KEYS | DISC_KEYS if n > 1 else GEN_KEYS - {"a"}), (n, keys)
        assert all(math.isfinite(v) for v in logs.values())
    assert first.count("| Valid results:") == 2 and "'asr'" in first
    assert "| Restored ckpt:" in resumed and "model_ckpt_steps_5.ckpt" in resumed
    m0, m2 = _init_model(root), c2["state_dict"]["model"]
    changed = {k for k in m0 if not torch.equal(m0[k], m2[k])}
    assert any(k.startswith("vc_asr.asr_decoder.") for k in changed)
    assert any(k.startswith("vc_asr.content_encoder.") for k in changed)
    assert not any(k.startswith("vc_asr.") and "running" in k for k in changed)


def _flagship_hp(root):
    return dict(FLAGSHIP_HP, mesh_shape="data:1", pretrain_asr_ckpt=str(root / "work"))


def test_flagships_warm_start_from_the_port(root, trained):
    """The port's and the JAX flagship read the port's VCPPG checkpoint."""
    from neuralsvb_tpu.models.svb_vae import SVBVAE
    from neuralsvb_tpu.tasks.svb_vae_task import SVBVAEMleTask as JaxTask
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    ckpt = _ckpt(root, 5)["state_dict"]["model"]
    want = {k[len("vc_asr."):]: v for k, v in ckpt.items() if k.startswith("vc_asr.")}
    with hparams_scope(_flagship_hp(root)):
        task = SVBVAEMleTask()
        task.build_model()
        task.build_train()
    got = task.model.vc_asr.state_dict()
    assert got.keys() < want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)

    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(_flagship_hp(root))
    try:
        jtask = JaxTask()
        jtask.build_model()
        st = jax.device_get(jtask.state)
    finally:
        jhparams.clear()
        jhparams.update(saved)
    jsd = vcasr_from_jax(st["params"]["vc_asr"], st["batch_stats"]["vc_asr"])
    assert all(torch.equal(jsd[k], got[k]) for k in jsd if not k.endswith("num_batches_tracked"))

    rng = np.random.RandomState(0)
    mel = (rng.randn(2, 48, 80) - 2).astype(np.float32)
    mel[1, 30:] = 0.0
    var = {"params": {"vc_asr": st["params"]["vc_asr"]},
           "batch_stats": {"vc_asr": st["batch_stats"]["vc_asr"]}}
    jh = np.asarray(jtask.model.apply(var, mel, method=SVBVAE.extract_ppg))
    with torch.no_grad():
        th = task.model.extract_ppg(torch.tensor(mel).transpose(1, 2))
    d = float(np.abs(th.transpose(1, 2).numpy() - jh).max())
    assert d <= 1e-5, d


@pytest.fixture
def jax_vcppg(root, trained):
    """The JAX VCPPGTask at the run's config, and the port's task with the
    same weights."""
    from neuralsvb_tpu.tasks.vc_ppg import VCPPGTask as JaxTask
    from neuralsvb_torch.tasks.vc_ppg import VCPPGTask
    hp = set_hparams(config=str(root / "cfg.yaml"), print_hparams=False,
                     global_hparams=False)
    hp = dict(hp, device="cpu", mesh_shape="data:1", work_dir=str(root / "work"))
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(hp)
    jtask = JaxTask()
    jtask.build_model()
    st = jax.device_get(jtask.state)
    jbatch = next(iter(jtask.val_dataloader()))
    with hparams_scope(dict(hp)):
        task = VCPPGTask()
        task.build_model()
        task.model.load_state_dict(vcppg_from_jax(st["params"], st["batch_stats"]))
        batch = next(iter(task.val_dataloader()))
    for k in ("mels", "pitch", "energy", "txt_tokens", "f0", "uv"):
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]), err_msg=k)
    yield jtask, task, hp, jbatch, batch
    jhparams.clear()
    jhparams.update(saved)


def test_jax_test_step_fault(jax_vcppg):
    jtask, task, hp, _, _ = jax_vcppg
    one = next(iter(jtask.test_dataloader()))
    with pytest.raises(KeyError, match="multi_spk_emb"):
        jtask.test_step(one, 0)
    with hparams_scope(dict(hp)), pytest.raises(NotImplementedError,
                                                match=r"svb_para\.py:136,220"):
        task.test()


def test_jax_validation_vis_fault(jax_vcppg):
    jtask, task, hp, jbatch, batch = jax_vcppg
    jtask.logger, jtask.vocoder, jtask.global_step = object(), object(), 0
    with pytest.raises(KeyError, match="prof_f0"):
        jtask.validation_step(jbatch, 0)
    jlosses, _, _, _ = jtask.forward_losses(
        jtask.state["params"], jtask.state["batch_stats"], jtask.prep_batch(jbatch, infer=True),
        jax.random.PRNGKey(0), train=False)

    class Logger:
        def add_audio(self, *a):
            raise AssertionError("nothing is rendered for a speech batch")
    with hparams_scope(dict(hp)):
        task.logger, task.global_step = Logger(), 0
        out = task.validation_step(batch, 0)
    assert out["losses"].keys() == {"l1", "ssim", "asr"} == jlosses.keys()
    for k, v in jlosses.items():
        np.testing.assert_allclose(out["losses"][k], float(v), rtol=1e-4, err_msg=k)


PARA_TASKS = {"SVBParaTask": {}, "ParaPPGConstraintTask": {}, "ParaPPGPreExpTask": {},
              "ParaAlignedPPGTask": {}, "ParaPPGPretrainedTask": {},
              "ParaPPGSpkConsistentTask": {},
              "AmtSpkTask": dict(ref_enc_out=256, use_energy=False)}


@pytest.mark.parametrize("name", list(PARA_TASKS))
def test_svb_para_renders_its_ways(tmp_path, name, capsys):
    """``SVBParaTask`` and its six subclasses through the training CLI's
    entry (``tasks.run.run_task``, ``task_cls`` on the recipe) on a
    paired synthetic split at tiny widths (one 32-frame discriminator
    window, so the discriminators act on its 48-frame item): one step, a
    resume to two (it restores every discriminator: the
    speaker-consistency task's ``_spk`` too), then ``--infer`` writes both
    ground truths and every way through the registry's vocoder (a tiny PWG,
    hop 128), frames x hop samples each; and a validation batch with a
    logger renders the three ways and reports each way's mel losses."""
    import glob
    import wave
    from neuralsvb_torch.data.synthetic import write_synthetic_split
    from neuralsvb_torch.tasks import svb_para
    from neuralsvb_torch.tasks.run import run_task
    data = str(tmp_path / "data")
    for prefix, frames, seed in (("train", (48,), 1), ("valid", (40,), 2),
                                 ("test", (44, 36), 3)):
        write_synthetic_split(data, frames, prefix=prefix, seed=seed)
    hp = set_hparams(config=RECIPE, print_hparams=False, global_hparams=False)
    hp.update(TINY, device="cpu", binary_data_dir=data, work_dir=str(tmp_path / "work"),
              vocoder="PWG", vocoder_ckpt="", max_updates=1, val_check_interval=1,
              disc_start_steps=0, disc_win_num=1,
              task_cls=f"neuralsvb_torch.tasks.svb_para.{name}",
              generator_params={"layers": 4, "stacks": 2, "residual_channels": 8,
                                "gate_channels": 16, "skip_channels": 8,
                                "aux_context_window": 0,
                                "upsample_params": {"upsample_scales": [4, 4, 8]}},
              **PARA_TASKS[name])
    for over in (dict(infer=False), dict(infer=False, max_updates=2), dict(infer=True)):
        with hparams_scope(dict(hp, **over)):
            run_task()
    out = capsys.readouterr().out
    steps = [json.loads(m) for m in re.findall(r"^\| step \d+: (\{.*\})$", out, re.M)]
    assert len(steps) == 2 and all(math.isfinite(v) for s in steps for v in s.values())
    spk = [k for k in steps[-1] if "_spk" in k]
    assert bool(spk) == (name == "ParaPPGSpkConsistentTask"), spk
    assert re.search(r"^\| Restored ckpt: .*model_ckpt_steps_1\.ckpt$", out, re.M)
    ckpt = torch.load(tmp_path / "work" / "model_ckpt_steps_2.ckpt", weights_only=True)
    assert ("mel_disc_spk" in ckpt["state_dict"]) == (name == "ParaPPGSpkConsistentTask")
    rendered = []

    class Logger:
        writes_figures = False  # as JsonLogger without matplotlib

        def add_audio(self, tag, wav, step, sr):
            rendered.append((tag, len(wav)))
    with hparams_scope(hp):
        task = getattr(svb_para, name)()
        batch = next(iter(task.val_dataloader()))
        task.build_model()
        task.logger, task.global_step = Logger(), 0
        out = task.validation_step(batch, 0)
    gen = tmp_path / "work" / "generated_2_" / "wavs"
    for key in ("gt_a", "gt_p", "a2a", "p2p", "a2p"):
        lengths = []
        for w in glob.glob(str(gen / f"{key}_wavout" / "*.wav")):
            with wave.open(w) as f:
                lengths.append(f.getnframes())
        if key in ("gt_a", "a2a"):  # the amateur side's frames
            assert sorted(lengths) == [36 * 128, 44 * 128], (key, lengths)
        assert len(lengths) == 2 and all(n % 128 == 0 and n > 0 for n in lengths), key
    assert [t for t, _ in rendered] == ["a2a_wavout_0", "p2p_wavout_0", "a2p_wavout_0"]
    # every task's validation reports exactly the three ways' mel losses:
    # the split has no transcripts, so the ASR terms (base, constraint and
    # pretrained tasks) do not run, and validation reports no adversarial term
    assert {"l1a2a", "ssima2a", "l1p2p", "ssimp2p", "l1a2p", "ssima2p"} == set(out["losses"]), (
        sorted(out["losses"]))
    assert all(math.isfinite(v) for v in out["losses"].values())
