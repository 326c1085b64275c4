"""The ``bigvgan_train`` cell at tiny widths on the CPU: the port's
``BigVGANTask`` through the ``fit_loop_bigvgan`` kind against the frozen
reference (``reference/bigvgan_step.py``), the faults and the control the
comparison has to catch, and the AMP readers on a synthetic trace."""

import importlib.util

import pytest
import torch

from svb_bench import flops, flops_bigvgan, run
from svb_bench.harness import BENCH, Result
from svb_bench.tests.conftest import bench
from svb_bench.tests.test_svb_bench_kinds import TASK_CLASSES, plant_training_fault
from svb_bench.trace import Trace

CELL = "bigvgan_train"
# six stages at the published rates, 256 channels halving to 4; crops of
# 1024 samples (4 frames), the shortest the MRD's 2048-point reflect pad takes.
# Under the published N(0, 0.01) init, narrower stages (64 halving to 1)
# pass the generator's gradients at rounding level, and two float32
# summation orders part over three Adam steps (change gaps of 0.02-0.04)
TINY = {"hparams": dict(upsample_initial_channel=256, max_samples=1024, max_sentences=2),
        "traffic": dict(items=4, item_seconds=[0.2, 0.4], trace_steps=1)}
GEN = dict(num_mels=100, upsample_rates=[4, 4, 2, 2, 2, 2],
           upsample_kernel_sizes=[8, 8, 4, 4, 4, 4], upsample_initial_channel=1536,
           resblock_kernel_sizes=[3, 7, 11], resblock_dilation_sizes=[[1, 3, 5]] * 3)


def run_tiny(seed=2 ** 31 + 4321, trace=0, control=0, seconds=0.5):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace), "--control", str(control)])
    return run.run_cell(args, device=torch.device("cpu"), require_cuda=False,
                        overrides=TINY, bench=bench())


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_bigvgan_train_matches_reference():
    line, res = run_tiny()
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_step_ms.vocoder", "setup_s"}
    assert line["checks"]["data_rows_off"]["value"] == 0
    # on the CPU both sides run float32 convolutions and the AMP's plain
    # twins: the losses of the first step agree to rounding
    assert line["checks"]["loss_rel.first"]["value"] < 1e-5


def test_bigvgan_traced_run_reports_its_per_layer_metrics():
    line, res = run_tiny(trace=1)
    assert line["correct"], line["checks"]
    # host-side readers read; the CPU has no CUDA events and runs no kernel,
    # so the update times and the AMP readers find nothing
    assert {"data_wait_ms.train.vocoder", "mfu.train.vocoder",
            "forward_ms.train.vocoder"} <= set(line["metrics"])
    assert res.record["amp_least_s"] > 0
    assert "amp_roofline.train" not in line["metrics"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "unchanged_after_3"])
def test_bigvgan_faults_are_not_correct(monkeypatch, fault):
    monkeypatch.setitem(TASK_CLASSES, CELL, ("neuralsvb_torch.tasks.vocoder_task",
                                             "BigVGANTask"))
    plant_training_fault(monkeypatch, fault, CELL)
    line, _ = run_tiny(seed=2 ** 31 + 77)
    assert not line["correct"], line["checks"]
    if fault != "half_batch":
        assert line["checks"]["change_norm_gap.window"]["value"] > 0.5, line["checks"]
    if fault == "unchanged_after_3":
        assert line["checks"]["change_norm_gap"]["value"] < 1e-3, line["checks"]


def test_bigvgan_control_is_not_correct():
    """The reference with TF32 operands (rounded to TF32 on the CPU) in the
    program's place."""
    line, _ = run_tiny(control=1)
    assert not line["correct"], line["checks"]


def test_amp_readers_read_a_trace_and_nothing_without_one():
    least = flops_bigvgan.amp_least_s(GEN, 4, 65536)
    # two traced steps whose AMP kernels took twice the least time in all
    us = least * 1e6
    tr = Trace(window=(0.0, 10 * us),
               kernels=[("amp_activation_fwd_kernel(float const*)", 0.0, us / 2),
                        ("amp_activation_bwd_kernel(float const*)", us, 1.5 * us),
                        ("amp_activation_reduce_kernel", 2 * us, 2.5 * us),
                        ("amp_activation_bwd_kernel(float const*)", 3 * us, 3.5 * us),
                        ("sm80_xmma_fprop_implicit_gemm", 4 * us, 9 * us)],
               spans=[("train_one", 0.0, 4 * us), ("train_one", 4 * us, 10 * us)])
    r = Result(1, 1, 0, 0, trace=tr)
    r.record = {"amp_least_s": least}
    assert reader("amp_roofline.train")(r) == pytest.approx(50.0)
    assert reader("amp_ms.train")(r) == pytest.approx(least * 1e3)
    for name in ("amp_roofline.train", "amp_ms.train"):
        assert reader(name)(Result(1, 1, 0, 0)) is None
    # a program without the AMP kernels (the parent of this cell) reads nothing
    bare = Trace(window=(0.0, 10.0), kernels=[("sm80_xmma_fprop", 0.0, 5.0)],
                 spans=[("train_one", 0.0, 10.0)])
    for name in ("amp_roofline.train", "amp_ms.train"):
        r = Result(1, 1, 0, 0, trace=bare)
        r.record = {"amp_least_s": least}
        assert reader(name)(r) is None


def test_step_work_and_amp_least_time():
    """The AMP's elements at the cell's shapes (629 M a pass) and its least
    time (bytes-bound: 20 bytes an element at 3.35 TB/s); the step's FLOPs
    grow linearly with the crops."""
    assert flops_bigvgan.amp_elements(GEN, 4, 65536) == 629_145_600
    assert flops_bigvgan.amp_least_s(GEN, 4, 65536) == pytest.approx(
        629_145_600 * 20 / flops.PEAK_HBM)
    hp = dict(mpd_reshapes=[2, 3, 5, 7, 11],
              resolutions=[[1024, 120, 600], [2048, 240, 1200], [512, 50, 240]])
    tiny = dict(GEN, upsample_initial_channel=64)
    one, two = (flops_bigvgan.step_flops(hp, tiny, b, 2048)["f32"] for b in (1, 2))
    assert two == 2 * one > 0
