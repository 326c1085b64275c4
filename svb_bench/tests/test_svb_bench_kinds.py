"""Each traffic kind end to end at tiny widths on the CPU: the port against
the frozen reference, and the faults the comparison has to catch."""

import pytest
import torch

from svb_bench.tests.conftest import run_tiny


def test_a2p_matches_reference():
    line, res = run_tiny("a2p_songs")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # on the CPU both sides run float32 with the same draws
    assert line["checks"]["a2p_mel_rel_l2"]["value"] < 1e-5
    assert line["checks"]["wav_rel_l2"]["value"] < 1e-4
    assert set(line["metrics"]) == {"audio_s_per_s", "latency_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"


def test_a2p_traced_run_reports_per_layer_metrics():
    line, res = run_tiny("a2p_songs", trace=1)
    assert line["correct"]
    assert {"device_idle.serve", "mfu.serve"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def alter_answers(monkeypatch):
    """Every wav altered where the vocoder produces it: its first tenth
    scaled by 1.2."""
    from neuralsvb_torch.vocoders.hifigan import HifiGAN
    spec2wav = HifiGAN.spec2wav

    def altered(self, mel, f0=None, **kw):
        wav = spec2wav(self, mel, f0=f0, **kw)
        wav[: len(wav) // 10] *= 1.2
        return wav
    monkeypatch.setattr(HifiGAN, "spec2wav", altered)


TASK_CLASSES = {"vocoder_train": ("neuralsvb_torch.tasks.vocoder_task", "HifiGanTask"),
                "svb_train": ("neuralsvb_torch.tasks.svb_vae_task", "SVBVAEMleTask")}


def _steps_then_nothing(step, n):
    """An optimizer's ``step`` that does nothing after its first ``n`` calls."""
    calls = []

    def stepped(closure=None):
        calls.append(1)
        return step(closure) if len(calls) <= n else None
    return stepped


def plant_training_fault(monkeypatch, fault, workload="vocoder_train"):
    """``state_unchanged``: the optimizers' steps do nothing;
    ``unchanged_after_3``: they do nothing after the 3 steps that set-up
    hands the reference, so only steps of the window go wrong;
    ``half_batch``: the step sees the first half of its batch, its means
    taken over that half."""
    import importlib
    mod, name = TASK_CLASSES[workload]
    cls = getattr(importlib.import_module(mod), name)
    if fault in ("state_unchanged", "unchanged_after_3"):
        build_train = cls.build_train
        n = 0 if fault == "state_unchanged" else 3

        def frozen(self):
            build_train(self)
            for opt in vars(self).values():
                if isinstance(opt, torch.optim.Optimizer):
                    opt.step = _steps_then_nothing(opt.step, n)
        monkeypatch.setattr(cls, "build_train", frozen)
    else:
        prep = cls._prep_batch

        def half(self, batch, *a, **k):
            b = prep(self, batch, *a, **k)
            n = max(1, len(b["mels"]) // 2)
            return {key: v[:n] for key, v in b.items()}
        monkeypatch.setattr(cls, "_prep_batch", half)


def test_a2p_answer_altered_is_not_correct(monkeypatch):
    alter_answers(monkeypatch)
    line, _ = run_tiny("a2p_songs", seed=2 ** 31 + 99)
    assert not line["correct"]


def test_a2p_control_is_not_correct():
    """The reference with float8 cluster operands in the program's place
    (TF32, the other half of the control, does nothing on the CPU)."""
    line, _ = run_tiny("a2p_songs", control=1)
    assert not line["correct"]
    assert line["checks"]["wav_rel_l2"]["value"] > 1e-2


def test_vocoder_train_matches_reference():
    line, res = run_tiny("vocoder_train")
    assert line["correct"], line["checks"]
    assert line["metrics"]["train_step_ms.vocoder"]["value"] > 0
    assert line["checks"]["data_rows_off"]["value"] == 0


@pytest.mark.parametrize("workload", ["vocoder_train", "svb_train"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "unchanged_after_3"])
def test_training_faults_are_not_correct(monkeypatch, fault, workload):
    plant_training_fault(monkeypatch, fault, workload)
    line, _ = run_tiny(workload, seed=2 ** 31 + 7)
    assert not line["correct"], line["checks"]
    if fault != "half_batch":
        # the step past the window moves nothing where the reference moves
        assert line["checks"]["change_norm_gap.window"]["value"] > 0.5, line["checks"]
    if fault == "unchanged_after_3":
        # the steps that set-up hands the reference are sound
        assert line["checks"]["change_norm_gap"]["value"] < 1e-3, line["checks"]


def test_svb_train_matches_reference():
    line, res = run_tiny("svb_train")
    assert line["correct"], line["checks"]
    # on the CPU both sides run the same float32 operations with the same draws
    assert line["checks"]["loss_rel"]["value"] == 0.0
    assert line["checks"]["loss_rel.window"]["value"] == 0.0
    assert line["checks"]["data_rows_off"]["value"] == 0


def test_vocoder_control_is_not_correct():
    line, _ = run_tiny("vocoder_train", control=1)
    assert not line["correct"], line["checks"]
