"""The readers of the program's spans (``program_spans.py`` and the seven
``metrics/<quantity>.train.py``): a synthetic store against a synthetic
trace, the refusals, and both training cells traced at tiny widths on the
CPU."""

from collections import namedtuple

import pytest

from svb_bench import program_spans
from svb_bench.harness import Result
from svb_bench.run import read_metric
from svb_bench.trace import Trace

Rec = namedtuple("Rec", "name parent thread start_ns end_ns")
QUANTITIES = {"prep_ms": "prep", "forward_ms": "forward", "backward_ms": "backward",
              "optim_ms": "optim", "sync_wait_ms": "sync_wait", "launches": "launches",
              "syncs": "syncs"}
T0_NS = 1_700_000_000_000_000_000  # the store's clock at the trace's start


def store():
    """Two steps of 10 ms on the store's clock, the first starting 1 ms
    into the trace: sync 0.5, prep 1, update.gen 6 (of which backward 2,
    optim 1, a model span 1.5), sync 2; nothing in the last 0.5 ms."""
    recs = []

    def add(name, parent, a_ms, b_ms):
        recs.append(Rec(name, parent, 1, T0_NS + int(a_ms * 1e6), T0_NS + int(b_ms * 1e6)))
        return len(recs) - 1

    for k in range(2):
        t = 1.0 + 20.0 * k
        st = add("train.step", -1, t, t + 10)
        add("train.sync", st, t, t + 0.5)
        add("task.prep_batch", st, t + 0.5, t + 1.5)
        gen = add("update.gen", st, t + 1.5, t + 7.5)
        add("svb.vae", gen, t + 2, t + 3.5)
        add("update.backward", gen, t + 4, t + 6)
        add("update.optim", gen, t + 6, t + 7)
        add("train.sync", st, t + 7.5, t + 9.5)
    recs.append(Rec("data.wait", -1, 1, T0_NS, T0_NS + 900_000))
    return recs


def traced():
    """A trace whose ``train_one`` spans hold the store's steps with 20 µs
    on each side, and runtime calls inside and outside them."""
    ones = [("train_one", 980.0, 11020.0), ("train_one", 20980.0, 31020.0)]
    host = []
    for base in (1000.0, 21000.0):
        host += [("cudaLaunchKernel", base + 100 + i, base + 101 + i) for i in range(30)]
        host += [("cuLaunchKernelEx", base + 200, base + 201),
                 ("cudaMemcpyAsync", base + 300, base + 301),
                 ("cudaStreamSynchronize", base + 302, base + 400),
                 ("cudaMemcpy", base + 500, base + 600),
                 ("cudaDeviceSynchronize", base + 9600, base + 9900)]
    host += [("cudaLaunchKernel", 15000.0, 15001.0), ("cudaDeviceSynchronize", 50.0, 60.0)]
    tr = Trace(window=(0.0, 40000.0), kernels=[], spans=ones, host_ops=host)
    return Result(setup_s=1.0, attempted=1, failed=0, memory_peak_bytes=0, trace=tr)


def test_the_split_and_the_counts(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: store())
    res = traced()
    got = program_spans.per_step(res)
    assert got == pytest.approx({"prep": 1.0, "forward": 3.0, "backward": 2.0, "optim": 1.0,
                                 "sync_wait": 2.5, "step": 10.0, "launches": 31.0,
                                 "syncs": 3.0})
    for q, key in QUANTITIES.items():
        for cell in ("vocoder", "svb"):
            assert read_metric(f"{q}.train.{cell}", res) == pytest.approx(got[key])


def test_older_records_in_the_store_are_left_out(monkeypatch):
    """A process that ran an earlier traced run keeps its records: the
    newest steps, one per ``train_one``, are this run's."""
    old = [Rec("train.step", -1, 1, 5, 10_000_005), Rec("update.optim", 0, 1, 6, 9_000_006)]
    new = [r._replace(parent=r.parent + 2 if r.parent >= 0 else -1) for r in store()]
    monkeypatch.setattr(program_spans, "records", lambda: old + new)
    got = program_spans.per_step(traced())
    assert got["optim"] == pytest.approx(1.0) and got["step"] == pytest.approx(10.0)


@pytest.mark.parametrize("case", ["not_nested", "no_store", "no_trace", "count_differs"])
def test_readers_give_nothing_where_the_store_cannot_be_read(monkeypatch, case):
    recs = store()
    if case == "not_nested":
        # the second step 100 µs later than its train_one allows
        recs = store()[:8] + [r._replace(start_ns=r.start_ns + 100_000,
                                         end_ns=r.end_ns + 100_000) for r in store()[8:]]
    elif case == "count_differs":
        recs = store()[:8]
    monkeypatch.setattr(program_spans, "records", lambda: None if case == "no_store" else recs)
    res = traced()
    if case == "no_trace":
        res.trace = None
    assert program_spans.per_step(res) is None
    for q in QUANTITIES:
        assert read_metric(f"{q}.train.svb", res) is None


def test_a_program_without_the_store_gives_nothing(monkeypatch):
    """The parent checkout's profiling module has no ``spans``."""
    from neuralsvb_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.records() is None
    assert program_spans.per_step(traced()) is None


@pytest.mark.parametrize("workload", ["vocoder_train", "svb_train"])
def test_a_traced_cell_reports_the_split(workload):
    from svb_bench.tests.conftest import run_tiny
    line, res = run_tiny(workload, trace=1)
    assert line["correct"], line["checks"]
    tag = workload.split("_")[0]
    got = {q: line["metrics"][f"{q}.train.{tag}"]["value"] for q in QUANTITIES}
    s = program_spans.per_step(res)
    parts = sum(got[q] for q in ("prep_ms", "forward_ms", "backward_ms", "optim_ms",
                                 "sync_wait_ms"))
    assert 0.9 * s["step"] <= parts <= s["step"]
    assert min(got[q] for q in ("forward_ms", "backward_ms", "optim_ms")) > 0
    # the CPU makes no CUDA call
    assert got["launches"] == got["syncs"] == 0
    one = [e - b for n, b, e in res.trace.spans if n == "train_one"]
    assert s["step"] <= sum(one) / len(one) * 1e-3
