"""The harness's arithmetic: percentiles over all requests, the rate over
the whole window, interval merging, and shares at 100% when the time
equals the least time."""

import importlib.util

import pytest

from svb_bench import flops, stats
from svb_bench.harness import BENCH, Result
from svb_bench.trace import Trace, merge


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result(**record):
    r = Result(setup_s=1.0, attempted=1, failed=0, memory_peak_bytes=0)
    r.record = record
    return r


def test_percentile_is_numpys_linear_over_all_values():
    np = pytest.importorskip("numpy")
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 100.0]
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_merge_unions_overlapping_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 11)]
    assert merge(spans) == [(0, 3), (5, 7), (10, 11)]


def test_trace_busy_idle_and_gaps():
    tr = Trace(window=(0.0, 10.0), kernels=[("a", 1.0, 3.0), ("b", 2.0, 4.0), ("a", 8.0, 9.0)],
               spans=[("forward", 0.0, 5.0), ("spec2wav", 5.0, 10.0)],
               host_ops=[("aten::conv1d", 4.0, 7.0)])
    assert tr.busy_s == pytest.approx(4e-6)
    assert tr.window_s == pytest.approx(1e-5)
    assert reader("device_idle.serve")(Result(1, 1, 0, 0, trace=tr)) == pytest.approx(60.0)
    gaps = dict((n, t) for n, t in tr.idle_gaps())
    assert gaps == pytest.approx({"forward:python": 1e-6, "spec2wav:aten::conv1d": 4e-6,
                                  "spec2wav:python": 1e-6})
    assert tr.device_ops()[0] == ["a", pytest.approx(3e-6)]


def test_roofline_and_mfu_are_100_at_the_least_time():
    least = flops.cluster_flops(1, flops.stage_shapes(2048, [8, 8, 2], 512), [3, 7, 11],
                                [[1, 3, 5]] * 3) / flops.PEAK_BF16
    tr = Trace(window=(0.0, least * 1e6), kernels=[("resblock_conv1d_bf16_kernel<1>", 0.0,
                                                     least * 1e6)], spans=[])
    r = Result(1, 1, 0, 0, trace=tr)
    r.record = {"cluster_least_s": least}
    assert reader("cluster_roofline.serve")(r) == pytest.approx(100.0)
    assert reader("mfu.serve")(result(least_s=[0.1, 0.2], latency_s=[0.1, 0.2])) == \
        pytest.approx(100.0)
    assert reader("mfu.train")(result(step_least_s=0.25, step_s=0.25)) == pytest.approx(100.0)


def test_readers_return_nothing_without_their_source():
    for name in ("svb_forward_ms.serve", "vocoder_ms.serve", "cluster_roofline.serve",
                 "device_idle.serve", "mfu.serve", "data_wait_ms.train", "gen_update_ms.train",
                 "disc_update_ms.train", "cluster_roofline.train", "device_idle.train",
                 "mfu.train"):
        assert reader(name)(result()) is None


def test_rate_is_over_the_whole_window():
    from svb_bench.harness import metrics_of
    from svb_bench.tests.conftest import bench as held_bench
    bench = held_bench()
    names = {m["name"] for m in metrics_of(bench, "a2p_songs", "end_to_end")}
    assert names == {"audio_s_per_s", "latency_p95_ms", "setup_s"}
    per = metrics_of(bench, "vocoder_train", "per_layer")
    assert all(m["moves"] == "train_step_ms.vocoder" for m in per)


def test_a_split_quantity_reads_its_quantity():
    from svb_bench.run import read_metric, split_base
    assert split_base("mfu.train.svb") == "mfu.train"
    r = result(step_least_s=0.05, step_s=0.2)
    assert read_metric("mfu.train.svb", r) == read_metric("mfu.train", r) == pytest.approx(25.0)
