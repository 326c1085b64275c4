"""The port's vocoder-training CLI end to end on the CPU at tiny widths:
``python -m neuralsvb_torch.tasks.run --config
hifigan_nsf_torch.yaml`` trains 3 steps (the discriminator from step 1,
as ``disc_start_steps`` 0 says),
validating at 0 and 2 and saving, then resumes to step 4. Checked: every
logged loss is finite, both optimizer groups change their parameters, the
resumed run starts from the saved step, ``config.yaml`` is written, and
``neuralsvb_torch.vocoders.hifigan.HifiGAN`` pointed at the work dir loads
the trained ``model_gen`` tensor for tensor."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from tests.test_torch_vocoder_step import write_vocoder_split  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "egs/datasets/audio/PopBuTFy/hifigan_nsf_torch.yaml")
HP = dict(upsample_rates=[8, 4, 4], upsample_kernel_sizes=[16, 8, 8],
          upsample_initial_channel=16, resblock_kernel_sizes=[3, 7],
          resblock_dilation_sizes=[[1, 3], [1, 3]], max_samples=1024, max_sentences=2,
          disc_start_steps=0, max_updates=3, val_check_interval=2, num_sanity_val_steps=1,
          tb_log_interval=1, num_ckpt_keep=2, ds_workers=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocoder_e2e")
    data = root / "data"
    write_vocoder_split(str(data), (20, 6, 12), "train", 3)
    write_vocoder_split(str(data), (9, 14), "valid", 4)
    (root / "cfg.yaml").write_text(yaml.safe_dump(
        dict(HP, base_config=[RECIPE], binary_data_dir=str(data))))

    def cli(hp=""):
        out = subprocess.run(
            [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config",
             str(root / "cfg.yaml"), "--hparams", f"device=cpu,work_dir={root / 'work'}{hp}"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
            timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        return out.stdout

    first = cli()
    c3 = torch.load(root / "work" / "model_ckpt_steps_3.ckpt", weights_only=True)
    resumed = cli(",max_updates=4")
    return root, first, resumed, c3


def _summary(stdout):
    return json.loads(re.search(r"^\| train summary: (\{.*\})$", stdout, re.M).group(1))


def test_trains_validates_and_resumes(run):
    root, first, resumed, c3 = run
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", first, re.M)}
    assert sorted(steps) == [1, 2, 3]
    gen, disc = {"mel", "a_p", "a_s", "lr_0"}, {"r_p", "f_p", "r_s", "f_s", "lr_1"}
    for n, logs in steps.items():  # "step n" logs step n - 1; step 0 <= disc_start_steps
        assert gen <= set(logs) and (disc <= set(logs)) == (n > 1), (n, logs)
        assert all(np.isfinite(v) for v in logs.values())
    assert first.count("| Valid results:") == 2  # sanity at 0 and at step 2
    s = _summary(first)
    # 3 steps + 1 sanity batch + 2 validation batches; the CPU runs no kernel
    assert s["vocoder_calls"] == 6 and s["resblock_conv1d_bf16_launches"] == 0
    assert {k: v["steps"] for k, v in s["phases"].items()} == {"gen": 1, "gen_disc": 2}

    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    hp = set_hparams(config=str(root / "cfg.yaml"), hparams_str="device=cpu",
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp):
        init = HifiGanTask()
        init.build_model()
    for name, module in (("model_gen", init.model), ("mpd", init.mpd), ("msd", init.msd)):
        sd = c3["state_dict"][name]
        assert any(not torch.equal(v, sd[k]) for k, v in module.state_dict().items()), name
    assert len(c3["optimizer_states"]) == 2

    assert "model_ckpt_steps_3.ckpt" in resumed and "Restored ckpt" in resumed
    rs = _summary(resumed)
    assert (rs["start_step"], rs["end_step"]) == (3, 4)
    assert sorted(os.listdir(root / "work")).count("model_ckpt_steps_4.ckpt") == 1


def test_vocoder_loads_the_trained_generator(run):
    root, *_ = run
    from neuralsvb_torch.vocoders.hifigan import HifiGAN
    cfg = yaml.safe_load((root / "work" / "config.yaml").read_text())
    assert cfg["upsample_rates"] == [8, 4, 4] and "infer" not in cfg
    voc = HifiGAN({"vocoder_ckpt": str(root / "work"), "device": "cpu",
                   "audio_sample_rate": 22050, "audio_num_mel_bins": 80})
    want = torch.load(root / "work" / "model_ckpt_steps_4.ckpt",
                      weights_only=True)["state_dict"]["model_gen"]
    got = voc.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    wav = voc.spec2wav(np.zeros((20, 80), np.float32) - 4, f0=np.full(20, 200.0))
    assert wav.shape == (20 * 128,) and torch.isfinite(wav).all()
