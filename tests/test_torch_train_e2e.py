"""The port's training CLI end to end on the CPU at tiny widths, without JAX.

A synthetic packed train/valid/test split (the port's builder) and a tiny
vocoder directory are written to a temporary directory. ``python -m
neuralsvb_torch.tasks.run`` trains 4 steps with ``phase_2_steps`` 1 (steps
0-1 in phase 2, 2-3 in phase 3), validating and saving every 2 steps, then
resumes to step 6, then ``--infer`` renders from the trained checkpoint.
Checked: the frozen ASR never changes (bit for bit), the latent map does
not change in phase 2 and is the only part of the model that changes in
phase 3, the discriminator does not change in phase 3, checkpoint
retention (``num_ckpt_keep`` 2), the resumed run's steps, validation audio,
the wav tree; in-process, that a resumed run reproduces an uninterrupted
one bit for bit.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, set_hparams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIBLING = os.path.join(REPO, "egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml")
VOC = dict(upsample_rates=[8, 4, 4], upsample_kernel_sizes=[16, 8, 8],
           upsample_initial_channel=16, resblock="1", resblock_kernel_sizes=[3, 7, 11],
           resblock_dilation_sizes=[[1, 3, 5]] * 3)
HP = dict(hidden_size=32, latent_size=8, fvae_enc_dec_hidden=16, fvae_kernel_size=5,
          fvae_enc_n_layers=2, fvae_dec_n_layers=2, asr_enc_layers=1, disc_win_num=2,
          mel_disc_hidden_size=8, collate_bucket_quant=16, pretrain_asr_ckpt="",
          phase_2_steps=1, max_updates=4, val_check_interval=2, valid_infer_interval=2,
          num_sanity_val_steps=1, num_valid_plots=1, num_ckpt_keep=2, tb_log_interval=1,
          ds_workers=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_e2e")
    data, voc = root / "data", root / "voc"
    write_synthetic_split(str(data), (72, 64, 80), prefix="train", seed=1)
    write_synthetic_split(str(data), (64, 56), prefix="valid", seed=2)
    write_synthetic_split(str(data), (64, 56), prefix="test", seed=3)
    voc.mkdir()
    (voc / "config.yaml").write_text(yaml.safe_dump(VOC))
    cfg = dict(HP, base_config=[SIBLING], binary_data_dir=str(data), vocoder_ckpt=str(voc))
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return root


def _cli(root, *args, hp=""):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config",
         str(root / "cfg.yaml"), *args, "--hparams",
         f"device=cpu,work_dir={root / 'work'}{hp}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _summary(stdout, what="train"):
    return json.loads(re.search(rf"^\| {what} summary: (\{{.*\}})$", stdout, re.M).group(1))


def _init_state(root):
    """The seeded initial model of the run (what step 0 starts from)."""
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    hp = set_hparams(config=str(root / "cfg.yaml"), hparams_str="device=cpu",
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp):
        task = SVBVAEMleTask()
        task.build_model()
        task.build_train()
        return task.model.state_dict(), task.mel_disc.state_dict()


def _ckpt(root, step):
    return torch.load(root / "work" / f"model_ckpt_steps_{step}.ckpt", weights_only=True)


def _changed(a, b):
    return {k for k in a if not torch.equal(a[k], b[k])}


@pytest.fixture(scope="module")
def trained(root):
    first = _cli(root)
    kept_after_first = sorted(os.listdir(root / "work"))
    c2, c4 = _ckpt(root, 2), _ckpt(root, 4)
    resumed = _cli(root, hp=",max_updates=6")
    return first, resumed, kept_after_first, c2, c4


def test_phases_touch_only_their_parameters(root, trained):
    _, _, _, c2, c4 = trained
    model0, disc0 = _init_state(root)
    m2, m4 = c2["state_dict"]["model"], c4["state_dict"]["model"]
    phase2 = _changed(model0, m2)  # steps 0-1: generator + discriminator
    assert phase2 and not any(k.startswith(("vc_asr.", "z_mapping_function.")) for k in phase2)
    assert _changed(disc0, c2["state_dict"]["mel_disc"])
    phase3 = _changed(m2, m4)  # steps 2-3: the latent map alone
    assert phase3 and all(k.startswith("z_mapping_function.") for k in phase3), phase3
    assert not _changed(c2["state_dict"]["mel_disc"], c4["state_dict"]["mel_disc"])
    assert not any(k.startswith("vc_asr.") for k in _changed(model0, m4))


def test_first_run_validates_saves_and_logs(root, trained):
    first, _, kept, c2, c4 = trained
    assert kept == ["config.yaml", "lightning_logs", "model_ckpt_steps_2.ckpt",
                    "model_ckpt_steps_4.ckpt"]
    assert (c2["global_step"], c4["global_step"]) == (2, 4)
    assert len(c4["optimizer_states"]) == 3
    assert first.count("| Valid results:") == 3  # sanity, step 2, step 4
    assert "a2p_mle" in first.split("| Valid results:")[-1]
    s = _summary(first)
    assert (s["start_step"], s["end_step"]) == (0, 4)
    assert {p: v["steps"] for p, v in s["phases"].items()} == {"2": 2, "3": 2}
    # the vocoder ran on CPU tensors: its plain twin, no kernel launch
    # sanity at step 0 (a2a, p2p, gt_a), steps 2 and 4 (a2a, p2p, a2p, gt_a)
    assert s["vocoder_calls"] == 3 + 4 + 4 and s["resblock_conv1d_bf16_launches"] == 0
    audio = sorted(os.path.basename(p) for p in glob.glob(
        str(root / "work" / "lightning_logs" / "version_0" / "audio" / "*.wav")))
    assert audio == [f"{w}_{b}_step{s}.wav" for w, b, s in (
        ("a2a_wavout", 0, 0), ("a2a_wavout", 0, 2), ("a2a_wavout", 0, 4),
        ("a2p_wavout", 0, 2), ("a2p_wavout", 0, 4),
        ("gt_a_wav", 0, 0), ("gt_a_wav", 0, 2), ("gt_a_wav", 0, 4),
        ("p2p_wavout", 0, 0), ("p2p_wavout", 0, 2), ("p2p_wavout", 0, 4))]
    metrics = [json.loads(line) for line in open(
        root / "work" / "lightning_logs" / "version_0" / "metrics.jsonl")]
    assert [m["step"] for m in metrics if "tr/total_loss_0" in m] == [1, 2]
    assert [m["step"] for m in metrics if "tr/total_loss_2" in m] == [3, 4]


def test_resume_continues_and_retention_holds(root, trained):
    _, resumed, _, _, c4 = trained
    assert "| Restored ckpt:" in resumed and "model_ckpt_steps_4.ckpt" in resumed
    assert "| Delete ckpt: model_ckpt_steps_2.ckpt" in resumed
    s = _summary(resumed)
    assert (s["start_step"], s["end_step"]) == (4, 6)
    assert s["phases"]["3"]["steps"] == 2
    assert sorted(glob.glob(str(root / "work" / "model_ckpt_steps_*.ckpt"))) == [
        str(root / "work" / f"model_ckpt_steps_{n}.ckpt") for n in (4, 6)]
    c6 = _ckpt(root, 6)
    assert all(k.startswith("z_mapping_function.")
               for k in _changed(c4["state_dict"]["model"], c6["state_dict"]["model"]))


def test_infer_renders_from_the_trained_checkpoint(root, trained):
    out = _cli(root, "--infer")
    assert "model_ckpt_steps_6.ckpt" in out
    gen = root / "work" / "generated_6_"
    for key in ("gt_a", "gt_p", "a2a", "p2p", "a2p"):
        wavs = sorted(glob.glob(str(gen / "wavs" / f"{key}_wavout" / "*.wav")))
        mels = sorted(glob.glob(str(gen / "mels" / f"{key}_mel" / "*.npy")))
        assert len(wavs) == len(mels) == 2, key
        for w, m in zip(wavs, mels):
            with wave.open(w) as f:
                assert f.getnframes() == np.load(m).shape[0] * 128


def _fit(root, work, max_updates):
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    from neuralsvb_torch.training.trainer import Trainer
    hp = set_hparams(config=str(root / "cfg.yaml"),
                     hparams_str=f"device=cpu,work_dir={work},max_updates={max_updates},"
                                 "num_sanity_val_steps=0,num_valid_plots=0",
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp) as h:
        Trainer.from_hparams(h).fit(SVBVAEMleTask())


def test_resume_reproduces_the_uninterrupted_run(root, tmp_path):
    """Every train item fits one batch, so the data order is the same either
    way; the model, discriminator, optimizers, schedules, the phase and the
    embedding column's host RNG must all come back from the checkpoint."""
    _fit(root, tmp_path / "a", 3)
    _fit(root, tmp_path / "b", 2)
    _fit(root, tmp_path / "b", 3)
    a = torch.load(tmp_path / "a" / "model_ckpt_steps_3.ckpt", weights_only=True)
    b = torch.load(tmp_path / "b" / "model_ckpt_steps_3.ckpt", weights_only=True)
    for part in ("model", "mel_disc"):
        assert not _changed(a["state_dict"][part], b["state_dict"][part]), part
    for oa, ob in zip(a["optimizer_states"], b["optimizer_states"]):
        for i, st in oa["state"].items():
            assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())
    assert torch.equal(a["emb_column_rng"]["keys"], b["emb_column_rng"]["keys"])


@pytest.mark.parametrize("device, error", [("", ValueError), ("cuda", RuntimeError)])
def test_training_needs_a_device_it_can_use(root, device, error):
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present")
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    hp = set_hparams(config=str(root / "cfg.yaml"), print_hparams=False,
                     global_hparams=False)
    hp.pop("device")
    if device:
        hp["device"] = device
    with hparams_scope(hp), pytest.raises(error):
        SVBVAEMleTask()

