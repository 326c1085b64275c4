"""The port's config system against ``neuralsvb_tpu.hparams``: the same
merged dict for the flagship recipe and its PyTorch sibling (whose only
differences are ``task_cls`` and ``device``), and the same ``--hparams``
override parsing. PyYAML is on both machines, so the port reads YAML with
it as the JAX package does."""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from neuralsvb_tpu import hparams as jhp  # noqa: E402
from neuralsvb_torch import hparams as thp  # noqa: E402

FLAGSHIP = "egs/datasets/audio/PopBuTFy/vae_global_mle_eng.yaml"
SIBLING = "egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml"


@pytest.mark.parametrize("path", [FLAGSHIP, SIBLING])
def test_same_merged_config(path):
    assert thp.load_config_recursive(path) == jhp.load_config_recursive(path)


def test_sibling_differs_only_in_task_and_device():
    base = jhp.load_config_recursive(FLAGSHIP)
    ours = thp.load_config_recursive(SIBLING)
    assert ours["task_cls"] == "neuralsvb_torch.tasks.svb_vae_task.SVBVAEMleTask"
    assert ours["device"] == "cuda"
    drop = {"task_cls", "device", "base_config"}
    assert ({k: v for k, v in ours.items() if k not in drop}
            == {k: v for k, v in base.items() if k not in drop})


def test_same_overrides():
    args = dict(config=SIBLING, hparams_str="device=cpu,hidden_size=32,"
                "mel_strides=[2 1 1],map_scheduler_params.gamma=0.25,lr=2",
                print_hparams=False, global_hparams=False)
    ours, ref = thp.set_hparams(**args), jhp.set_hparams(**args)
    assert ours == ref
    assert ours["device"] == "cpu" and ours["hidden_size"] == 32
    assert ours["mel_strides"] == [2, 1, 1]
    assert ours["map_scheduler_params"]["gamma"] == 0.25
