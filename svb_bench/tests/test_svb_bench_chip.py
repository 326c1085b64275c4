"""On the card, at each cell's own size: the control (the reference in the
precision below the configuration's, in the program's place) and the
faults that a cell can have must each make ``correct`` false. Their
readings are the upper ends the limits are set below (PERF.md).

    python -m pytest svb_bench/tests/test_svb_bench_chip.py -m cuda -s

Each case prints its checks as ``READING <case> <seed> {...}``."""

import json

import pytest

from svb_bench import run

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 3 * 2 ** 30 + 303)
pytestmark = pytest.mark.cuda


def run_on_card(workload, seed, control=0, seconds=2):
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", "0", "--control", str(control)])
    line, res = run.run_cell(args)
    # a control run also reads the program's own numbers
    for note in res.notes:
        if note.startswith("program: "):
            print(f"READING {workload}.program {seed} {note[len('program: '):]}", flush=True)
    return line


def report(case, seed, line):
    print(f"READING {case} {seed} {json.dumps(line['checks'])}", flush=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["vocoder_train", "svb_train"])
def test_control_is_not_correct(cuda_device, workload, seed):
    line = run_on_card(workload, seed, control=1)
    report(f"{workload}.control", seed, line)
    assert not line["correct"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "unchanged_after_3"])
@pytest.mark.parametrize("workload", ["vocoder_train", "svb_train"])
def test_training_fault_is_not_correct(cuda_device, monkeypatch, workload, fault, seed):
    from svb_bench.tests.test_svb_bench_kinds import plant_training_fault
    plant_training_fault(monkeypatch, fault, workload)
    line = run_on_card(workload, seed)
    report(f"{workload}.{fault}", seed, line)
    assert not line["correct"]
