"""On the card, at the ``bigvgan_train`` cell's own size: the control (the
reference with TF32 in the program's place) and each fault must make
``correct`` false. Their readings are the upper ends the cell's limits are
set below (PERF.md).

    python -m pytest svb_bench/tests/test_svb_bench_bigvgan_chip.py -m cuda -s

Each case prints its checks as ``READING <case> <seed> {...}``."""

import pytest

from svb_bench.tests.test_svb_bench_chip import SEEDS, report, run_on_card
from svb_bench.tests.test_svb_bench_kinds import TASK_CLASSES, plant_training_fault

CELL = "bigvgan_train"
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("seed", SEEDS)
def test_bigvgan_control_is_not_correct(cuda_device, seed):
    line = run_on_card(CELL, seed, control=1)
    report(f"{CELL}.control", seed, line)
    assert not line["correct"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "unchanged_after_3"])
def test_bigvgan_fault_is_not_correct(cuda_device, monkeypatch, fault, seed):
    monkeypatch.setitem(TASK_CLASSES, CELL, ("neuralsvb_torch.tasks.vocoder_task",
                                             "BigVGANTask"))
    plant_training_fault(monkeypatch, fault, CELL)
    line = run_on_card(CELL, seed)
    report(f"{CELL}.{fault}", seed, line)
    assert not line["correct"]
