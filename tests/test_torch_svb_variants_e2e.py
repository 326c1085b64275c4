"""The four other SVB tasks end to end on the CPU at tiny widths, without
JAX, on the synthetic splits of ``tests/test_torch_train_e2e.py``.

The seg technique-prior recipe (``vae_seg_tech_mle_eng_torch.yaml``)
through the CLI: 4 steps with ``phase_2_steps`` 1, a resume to step 6, then
``--infer`` writing the 5-wav tree. Checked: each phase's loss keys (the map
step has no ``a2p_mle``, as in the JAX package; validation reports it), the
attention modules train with the generator, the latent map is the only part
that changes in phase 3, the frozen ASR never changes.

In-process, each of the four task classes (the technique recipe's and the
two variants reached through ``task_cls``): train 2 steps across the phases
and render the test split; the boost task validates a2p already in phase 2.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from tests.test_torch_train_e2e import HP, VOC, _changed, _ckpt, _cli, _summary  # noqa: E402

from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, set_hparams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(REPO, "egs/datasets/audio/PopBuTFy")
SEG = os.path.join(RECIPES, "vae_seg_tech_mle_eng_torch.yaml")
TECH = os.path.join(RECIPES, "vae_tech_mle_eng_torch.yaml")
PKG = "neuralsvb_torch.tasks.svb_vae_task"
# task class -> (recipe, its mapping modules, hparams over the recipe's)
TASKS = {
    "SVBVAETechMleTask": (TECH, ("z_mapping_function",), {}),
    "SVBVAESegTechMleTask": (SEG, ("z_mapping_function",), {}),
    "SVBVAEBoostTask": (TECH, ("m_mapping_function", "logs_mapping_function"),
                        {"task_cls": f"{PKG}.SVBVAEBoostTask"}),
    "SVBVAETask": (TECH, ("m_mapping_function", "logs_mapping_function"),
                   {"task_cls": f"{PKG}.SVBVAETask", "latent_size": 16}),
}
WAVS = ("gt_a", "gt_p", "a2a", "p2p", "a2p")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants_e2e")
    data, voc = root / "data", root / "voc"
    write_synthetic_split(str(data), (72, 64, 80), prefix="train", seed=1)
    write_synthetic_split(str(data), (64, 56), prefix="valid", seed=2)
    write_synthetic_split(str(data), (64, 56), prefix="test", seed=3)
    voc.mkdir()
    (voc / "config.yaml").write_text(yaml.safe_dump(VOC))
    cfg = dict(HP, base_config=[SEG], binary_data_dir=str(data), vocoder_ckpt=str(voc))
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return root


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the CLI processes (``_cli`` passes
    the environment on): the suite runs its files in parallel workers on a
    few cores, where every process's full thread pool would oversubscribe
    them; tiny widths gain nothing from more threads."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _steps(stdout):
    return {int(m.group(1)): json.loads(m.group(2))
            for m in re.finditer(r"^\| step (\d+): (\{.*\})$", stdout, re.M)}


def test_seg_recipe_trains_resumes_and_renders(root):
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAESegTechMleTask
    first = _cli(root)
    hp = set_hparams(config=str(root / "cfg.yaml"), hparams_str="device=cpu",
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp):
        init = SVBVAESegTechMleTask()
        init.build_model()
        init.build_train()
    model0 = init.model.state_dict()
    steps = _steps(first)
    assert sorted(steps) == [1, 2, 3, 4]
    # logged at 1-2 (steps 0-1, phase 2): the generator, and from step 1 the
    # discriminator; at 3-4 (steps 2-3, phase 3): the map
    assert {"a2a_kl", "p2p_kl", "l1p2p", "lr_0"} <= set(steps[1])
    assert {"a2a_kl", "p2p_kl", "l1p2p", "a2a_a", "p2p_r", "lr_0", "lr_1"} <= set(steps[2])
    for s in (3, 4):
        assert {"l1a2p", "ssima2p", "a2p_a", "lr_2"} <= set(steps[s])
        assert "a2p_mle" not in steps[s] and "a2p_kl" not in steps[s]
    assert all(np.isfinite(v) for logs in steps.values() for v in logs.values())
    assert "a2p_mle" in first.split("| Valid results:")[-1]
    c2, c4 = _ckpt(root, 2), _ckpt(root, 4)
    phase2 = _changed(model0, c2["state_dict"]["model"])
    assert any(k.startswith("seg_ref_attn.") for k in phase2)
    assert any(k.startswith("k_mel_encoder_bn.running") for k in phase2)
    assert not any(k.startswith(("vc_asr.", "z_mapping_function.")) for k in phase2)
    phase3 = _changed(c2["state_dict"]["model"], c4["state_dict"]["model"])
    assert phase3 and all(k.startswith("z_mapping_function.") for k in phase3), phase3

    resumed = _cli(root, hp=",max_updates=6")
    assert "model_ckpt_steps_4.ckpt" in resumed
    assert (_summary(resumed)["start_step"], _summary(resumed)["end_step"]) == (4, 6)
    c6 = _ckpt(root, 6)
    assert not any(k.startswith("vc_asr.") for k in _changed(model0, c6["state_dict"]["model"]))

    out = _cli(root, "--infer")
    assert "model_ckpt_steps_6.ckpt" in out
    gen = root / "work" / "generated_6_"
    for key in WAVS:
        assert len(glob.glob(str(gen / "wavs" / f"{key}_wavout" / "*.wav"))) == 2, key
        assert len(glob.glob(str(gen / "mels" / f"{key}_mel" / "*.npy"))) == 2, key


@pytest.mark.parametrize("name", list(TASKS))
def test_task_trains_and_renders(root, tmp_path, capsys, name):
    from neuralsvb_torch.tasks import svb_vae_task as t
    from neuralsvb_torch.training.trainer import Trainer
    recipe, maps, over = TASKS[name]
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(dict(
        yaml.safe_load((root / "cfg.yaml").read_text()), base_config=[recipe], **over)))
    hp = set_hparams(config=str(cfg), hparams_str=f"device=cpu,work_dir={tmp_path / 'w'},"
                     "max_updates=2,phase_2_steps=0,val_check_interval=2,"
                     "valid_infer_interval=2",
                     print_hparams=False, global_hparams=False)
    assert hp["task_cls"] == f"{PKG}.{name}"
    cls = getattr(t, name)
    with hparams_scope(hp) as h:
        task = cls()
        summary = Trainer.from_hparams(h).fit(task)
        assert task.model.variant == cls.variant and task.model.mapping_keys == maps
        h["infer"] = True
        infer = cls().test()
    out = capsys.readouterr().out
    assert {p: v["steps"] for p, v in summary["phases"].items()} == {"2": 1, "3": 1}
    sanity = out.split("| Valid results:")[1].split("\n")[0]
    key = "a2p_mle" if "z_mapping_function" in maps else "a2p_kl"
    assert (key in sanity) == (name == "SVBVAEBoostTask")  # a2p validated in phase 2
    assert key in out.split("| Valid results:")[-1]
    # sanity (a2a, p2p[, a2p], gt_a) and step 2 (a2a, p2p, a2p, gt_a)
    assert summary["vocoder_calls"] == (4 if name == "SVBVAEBoostTask" else 3) + 4
    assert infer["utts"] == 2
    gen = tmp_path / "w" / "generated_2_"
    for k in WAVS:
        assert len(glob.glob(str(gen / "wavs" / f"{k}_wavout" / "*.wav"))) == 2, k

