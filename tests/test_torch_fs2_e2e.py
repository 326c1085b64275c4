"""FastSpeech2 end to end on the CPU at tiny widths, and the binarizer's
``with_f0cwt`` against the JAX package's.

The synthetic speech corpus of ``tests/test_torch_vcppg_e2e.py``
(``write_synthetic_speech_corpus``: 2 speakers x 3 utterances of 1.0-1.3 s
with transcripts), here with an MFA TextGrid per utterance, goes through
``python -m neuralsvb_torch.data.binarize --config fs2_adv_torch.yaml``
(``with_align``, ``with_word``, ``with_f0cwt``); ``python -m
neuralsvb_torch.tasks.run`` trains ``FastSpeech2AdvTask`` 3 steps
(discriminator from step 1, validating at 0 and 2), resumes to 5 and
renders ``--infer`` through a tiny random-init HiFiGAN (hop 128). Checked:
the items carry ``mel2ph``, ``ph2word`` and the CWT of their f0; every
logged loss is finite with the recipe's keys; the resumed run starts at
step 3; each test item gives a ``P`` and a ``G`` wav of mel frames x hop
samples, the predicted mel and the two f0 tracks.

The CWT fields the port's binarizer writes equal the JAX binarizer's
``get_f0cwt`` of the same f0 (plain and with the paired binarizer's
``prof_`` prefix), and the paired binarizer's ``process_item`` writes both
sides' fields, as the JAX one does.
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

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from neuralsvb_torch.data.indexed_dataset import IndexedDataset  # noqa: E402
from neuralsvb_torch.data.synthetic import write_synthetic_speech_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "egs/egs_bases/tts/fs2_adv_torch.yaml")
HOP = 128
TINY = dict(hidden_size=32, enc_layers=1, dec_layers=1, predictor_hidden=16,
            mel_disc_hidden_size=8, disc_win_num=2, test_num=2, ds_workers=1,
            max_updates=3, val_check_interval=2, num_sanity_val_steps=1, tb_log_interval=1,
            num_valid_plots=1, valid_infer_interval=2, warmup_updates=2,
            vocoder="hifigan", upsample_rates=[8, 4, 4], upsample_kernel_sizes=[16, 8, 8],
            upsample_initial_channel=8, lambda_f0=0.1, lambda_ph_dur=0.1)
GEN_KEYS, DISC_KEYS = {"l1", "ssim", "pdur", "sdur", "f0", "uv", "a", "lr_0"}, {"r", "f", "lr_1"}
CWT_KEYS = ("cwt_spec", "cwt_scales", "f0_mean", "f0_std")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fs2_e2e")
    processed = str(root / "processed")
    write_synthetic_speech_corpus(processed, 2, 3, seconds=(1.0, 1.3), textgrids=True)
    cfg = dict(TINY, base_config=[RECIPE], processed_data_dir=processed,
               binary_data_dir=str(root / "binary"), vocoder_ckpt=str(root / "no_vocoder"),
               binarization_args={"with_f0cwt": True})
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return root


def _cli(root, module, *args, hp=""):
    out = subprocess.run(
        [sys.executable, "-m", module, "--config", str(root / "cfg.yaml"), *args,
         "--hparams", f"device=cpu,work_dir={root / 'work'}{hp}"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def runs(root):
    return (_cli(root, "neuralsvb_torch.data.binarize"), _cli(root, "neuralsvb_torch.tasks.run"),
            _cli(root, "neuralsvb_torch.tasks.run", hp=",max_updates=5"),
            _cli(root, "neuralsvb_torch.tasks.run", "--infer", hp=",max_updates=5"))


def test_binarize_train_resume_infer(root, runs):
    binarized, first, resumed, infer = runs
    assert "| Build phone set." in binarized
    items = [IndexedDataset(str(root / "binary" / "train"))[i] for i in range(4)]
    for it in items:
        assert it["mel2ph"].max() == len(it["phone"]) - 1  # <EOS> is silence
        assert len(it["ph2word"]) == len(it["phone"])
        assert it["cwt_spec"].shape == (len(it["mel"]), 10)
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", first + resumed, re.M)}
    assert sorted(steps) == [1, 2, 3, 4, 5]
    for n, logs in steps.items():  # "step n" logs step n - 1; the disc from step 1
        keys = set(logs) - {"total_loss_0", "total_loss_1"}
        assert keys == (GEN_KEYS | DISC_KEYS if n > 1 else GEN_KEYS - {"a"}), (n, keys)
        assert all(math.isfinite(v) for v in logs.values())
    assert first.count("| Valid results:") == 2 and "'pdur'" in first
    audio = sorted(p.name for p in (root / "work" / "lightning_logs").glob("version_0/audio/*.wav"))
    assert audio == ["wav_0_step0.wav", "wav_0_step2.wav"]  # validation's vocoded prediction
    assert "| Restored ckpt:" in resumed and "model_ckpt_steps_5.ckpt" in resumed
    summary = json.loads(re.search(r"^\| infer summary: (\{.*\})$", infer, re.M).group(1))
    assert summary["utts"] == 2 and summary["vocoder_calls"] == 4
    gen = root / "work" / "generated_5_"
    test = IndexedDataset(str(root / "binary" / "test"))
    frames = sorted(len(test[i]["mel"]) for i in range(len(test)))
    for kind in ("p_wavout", "g_wavout"):
        from neuralsvb_torch.ops.audio import load_wav
        wavs = sorted(gen.glob(f"wavs/{kind}/*.wav"))
        assert len(wavs) == 2
        assert sorted(len(load_wav(str(w), sr=22050)[0]) for w in wavs) == [f * HOP for f in frames]
    mels = sorted(gen.glob("mels/mel/*.npy"))
    assert sorted(np.load(m).shape[0] for m in mels) == frames
    assert len(list(gen.glob("plot/[[]F0[]]*.npy"))) == 2


def test_f0cwt_items_match_jax(root, runs):
    """The packed CWT fields are the JAX ``get_f0cwt`` of the packed f0."""
    from neuralsvb_tpu.data.binarizer import BaseBinarizer as J
    from neuralsvb_torch.data.binarizer import BaseBinarizer as Tb
    for split in ("train", "test"):
        ds = IndexedDataset(str(root / "binary" / split))
        for i in range(len(ds)):
            it = ds[i]
            for prefix in ("", "prof_"):
                want = {f"{prefix}f0": np.asarray(it["f0"])}
                got = dict(want)
                J.get_f0cwt(want, prefix)
                Tb.get_f0cwt(got, prefix)
                for k in CWT_KEYS:
                    np.testing.assert_array_equal(got[prefix + k], want[prefix + k])
                    np.testing.assert_array_equal(it[k], want[prefix + k])


def test_paired_binarizer_writes_both_sides_cwt(tmp_path):
    """``PopBuTFyENBinarizer.process_item`` with ``with_f0cwt``: both sides'
    fields, each the CWT of that side's f0, and the key set of the JAX
    binarizer's item."""
    from tests.test_torch_binarize_e2e import SR, _sing
    from neuralsvb_tpu.data.binarizer import PopBuTFyENBinarizer as J
    from neuralsvb_tpu.hparams import hparams_scope as j_scope
    from neuralsvb_torch.data.binarizer import PopBuTFyENBinarizer as Tb
    from neuralsvb_torch.hparams import hparams_scope as t_scope
    from neuralsvb_torch.ops.audio import save_wav
    a, p = str(tmp_path / "A#singing#S_Amateur_0.wav"), str(tmp_path / "A#singing#S_Professional_0.wav")
    save_wav(_sing(226.0, 1.0, seed=0), a, SR)
    save_wav(_sing(220.0, 0.95, seed=1), p, SR)
    args = {"with_f0": True, "with_f0cwt": True}
    hp = {"audio_sample_rate": SR, "fft_size": 512, "hop_size": 128, "win_size": 512,
          "audio_num_mel_bins": 80, "fmin": 50, "fmax": 11025, "vocoder": "pwg",
          "vocoder_ckpt": "", "binary_data_dir": str(tmp_path), "max_mel_tech_gap": 800,
          "pitch_extractor": "autocorr"}
    with t_scope(dict(hp, device="cpu")):
        got = Tb.process_item("A#singing#S_Amateur_0", a, 0, p, args)
    with j_scope(hp):
        want = J.process_item("A#singing#S_Amateur_0", a, 0, p, args)
    assert set(got) == set(want)
    for prefix in ("", "prof_"):
        ref = {f"{prefix}f0": got[f"{prefix}f0"]}
        J.get_f0cwt(ref, prefix)
        for k in CWT_KEYS:
            np.testing.assert_array_equal(got[prefix + k], ref[prefix + k])


@pytest.mark.parametrize("cls, over", [
    ("FastSpeechDataset", {"pitch_type": "cwt"}),
    ("FastSpeechDataset", {"use_pitch_embed": False}),
    ("FastSpeechWordDataset", {}),
    ("FastSpeechWordDataset", {"use_word_input": True}),
])
def test_datasets_collate_as_jax(root, runs, cls, over):
    """The port's FastSpeech datasets over the binarized split: every field
    of the collated batch and the ``f0_mean``/``f0_std`` attributes equal
    the JAX datasets'."""
    import importlib
    from neuralsvb_tpu.hparams import hparams as jhparams
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    hp = dict(set_hparams(config=str(root / "cfg.yaml"), print_hparams=False,
                          global_hparams=False), **over)
    saved = dict(jhparams)
    try:
        jhparams.clear()
        jhparams.update(hp)
        jds = getattr(importlib.import_module("neuralsvb_tpu.data.datasets"), cls)("train")
        want = jds.collater([jds[i] for i in range(len(jds))])
    finally:
        jhparams.clear()
        jhparams.update(saved)
    with hparams_scope(dict(hp)):
        tds = getattr(importlib.import_module("neuralsvb_torch.data.datasets"), cls)("train")
        got = tds.collater([tds[i] for i in range(len(tds))])
    assert (tds.f0_mean, tds.f0_std) == (jds.f0_mean, jds.f0_std)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    assert ("cwt_spec" in got) == (over.get("pitch_type") == "cwt")
    assert (got["pitch"] is None) == (over.get("use_pitch_embed") is False)
