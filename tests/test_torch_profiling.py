"""The port's profiling module (``neuralsvb_torch/utils/profiling.py``)
against the JAX package's (``neuralsvb_tpu/utils/profiling.py``): the
real-time factor (the JAX ``Timer`` has no counterpart: the port records
spans, ``tests/test_torch_tracing.py``), the roofline with patched peaks,
the card's peak tables, interval merging, ``op_flops`` against XLA's cost model
(within 10%), and ``device_busy`` / ``top_ops`` on a CPU capture (keyed as
the host) and on CUDA-like events from two overlapping streams."""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralsvb_torch.utils import profiling as P  # noqa: E402
from neuralsvb_tpu.utils import profiling as JP  # noqa: E402


def test_timer_and_rtf():
    m = P.RTFMeter()
    m.add(0.5, 10.0)
    assert abs(m.rtf - 0.05) < 1e-9


def test_roofline_with_patched_peaks(monkeypatch):
    """Known peaks: 100 GFLOP/s, 10 GB/s (JAX's test_compiled_cost_and_roofline)."""
    monkeypatch.setattr(P, "peak_flops_for_device", lambda dtype=None: 100e9)
    monkeypatch.setattr(P, "peak_hbm_bytes_for_device", lambda: 10e9)
    monkeypatch.setattr(JP, "peak_flops_for_device", lambda: 100e9)
    monkeypatch.setattr(JP, "peak_hbm_bytes_for_device", lambda: 10e9)
    for args in ((1e9, 1e3, 20e-3), (1e3, 100e6, 10e-3), (0.0, 0.0, 1e-3), (1e9, 1e3, 0.0)):
        assert P.roofline(*args) == JP.roofline(*args), args
    lb, frac, which = P.roofline(1e9, 1e3, 20e-3)  # compute-bound: 10 ms
    assert which == "compute" and abs(lb - 10e-3) < 1e-9 and abs(frac - 0.5) < 1e-9
    lb, frac, which = P.roofline(1e3, 100e6, 10e-3)  # bandwidth-bound: 10 ms
    assert which == "bandwidth" and abs(frac - 1.0) < 1e-9
    assert P.roofline(0.0, 0.0, 1e-3) == (None, None, None)


def test_peaks_by_card_name(monkeypatch):
    """The H100 SXM5 data sheet's dense rates; 0.0 (and no roofline) for an
    unknown card and on the CPU."""
    assert P.peak_flops_for_device() == 0.0 or torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert P.peak_flops_for_device() == P.peak_flops_for_device(torch.bfloat16) == 989.4e12
    assert P.peak_flops_for_device(torch.float16) == 989.4e12
    assert P.peak_flops_for_device("tf32") == 494.7e12
    assert P.peak_flops_for_device(torch.float32) == 66.9e12
    assert P.peak_flops_for_device(torch.float64) == 0.0
    assert P.peak_hbm_bytes_for_device() == 3.35e12
    # the flagship vocoder's ResBlock clusters at the 2048-frame bucket:
    # 2 x 126 taps x C^2 x T FLOPs per stage, operations-bound at 1.094 ms
    flops = sum(2 * 126 * C * C * T for C, T in ((256, 16384), (128, 131072), (64, 262144)))
    bound, _, which = P.roofline(flops, 1e9, 5e-3)
    assert which == "compute" and round(bound * 1e3, 3) == 1.094
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Some Other Card")
    assert P.peak_flops_for_device() == P.peak_hbm_bytes_for_device() == 0.0
    assert P.roofline(1e9, 1e9, 1.0) == (None, None, None)


def test_merged_span_seconds_overlap():
    """[0,10] contains [2,5]; [20,30] overlaps [25,40]: 30, as JAX merges
    an xplane line (there in picoseconds)."""
    spans = [(0, 10), (2, 5), (20, 30), (25, 40)]
    line = SimpleNamespace(events=[SimpleNamespace(offset_ps=s, duration_ps=e - s)
                                   for s, e in spans])
    assert P.merged_span_seconds(spans) == 30
    assert P.merged_span_seconds(spans) * 1e-12 == pytest.approx(JP._merged_span_seconds(line))
    assert P.merged_span_seconds([]) == 0


def test_op_flops_matches_jax_compiled_cost():
    x = np.random.RandomState(0).randn(128, 128).astype(np.float32)
    want = JP.compiled_cost(jax.jit(lambda a: (a @ a).sum()), jnp.asarray(x))
    got = P.op_cost(lambda a: (a @ a).sum(), torch.as_tensor(x))
    assert want["flops"] > 0 and abs(got["flops"] - want["flops"]) / want["flops"] < 0.1
    assert got["bytes"] >= 2 * 128 * 128 * 4  # operand + product at least
    # one conv1d, NWC in JAX and NCW here
    rng = np.random.RandomState(1)
    xi, w = rng.randn(2, 100, 8).astype(np.float32), rng.randn(5, 8, 16).astype(np.float32)
    conv = jax.jit(lambda a, k: jax.lax.conv_general_dilated(
        a, k, (1,), [(2, 2)], dimension_numbers=("NWC", "WIO", "NWC")))
    want = JP.compiled_flops(conv, jnp.asarray(xi), jnp.asarray(w))
    got = P.op_flops(torch.nn.functional.conv1d, torch.as_tensor(xi).transpose(1, 2),
                     torch.as_tensor(w).permute(2, 1, 0), padding=2)
    assert want > 0 and abs(got - want) / want < 0.1
    assert got == 2 * 2 * 100 * 16 * 8 * 5  # 2 x MACs


def test_device_busy_and_top_ops_on_a_cpu_capture(tmp_path):
    x = torch.randn(256, 256)
    with P.profiler_trace(str(tmp_path)) as prof:
        for _ in range(3):
            (x @ x).sum()
    busy = P.device_busy(prof)
    assert list(busy) == ["cpu"] and 0 < busy["cpu"] < 60  # seconds
    top = P.top_ops(prof, k=5)
    assert 0 < len(top) <= 5 and all(s >= 0 and n > 0 for _, s, n in top)
    assert "aten::mm" in {name for name, _, _ in P.top_ops(prof, k=50)}
    assert [s for _, s, _ in top] == sorted((s for _, s, _ in top), reverse=True)
    assert P.kernel_split(prof) == ({}, 0)  # no device events on the CPU
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))


def _event(name, start, end, device="CUDA", index=0, annotation=False):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                           device_index=index, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_time=end - start, self_cpu_time_total=0.0)


def test_device_busy_merges_overlapping_streams():
    """Two kernels on two streams overlap by 50 µs: the merged busy time is
    the union, ``kernel_split`` the sum; user annotations and the
    optimizer's range are left out of both."""
    events = [_event("resblock_conv1d_bf16_kernel", 0, 100),
              _event("ampere_sgemm_128x64", 50, 150),
              _event("lrelu_bf16_kernel", 200, 210),
              _event("ProfilerStep#1", 0, 300, annotation=True),
              _event("Optimizer.step#Adam.step", 0, 300),
              _event("aten::mm", 0, 400, device="CPU")]
    prof = SimpleNamespace(events=lambda: events)
    assert P.device_busy(prof) == {"cuda:0": pytest.approx(160e-6)}
    kinds, ops = P.kernel_split(prof)
    assert ops == 3 and sum(v[0] for v in kinds.values()) == pytest.approx(0.21)  # ms
    assert kinds["ResBlock cluster kernels"] == [pytest.approx(0.11), 2]
    assert kinds["matmul (cuBLAS)"] == [pytest.approx(0.1), 1]
    assert P.top_ops(prof, k=2) == [("resblock_conv1d_bf16_kernel", pytest.approx(1e-4), 1),
                                    ("ampere_sgemm_128x64", pytest.approx(1e-4), 1)]
    assert P.kernel_kind("void cutlass::Kernel2<cutlass_80_simt_sgemm>") == "matmul (cuBLAS)"
    assert P.kernel_kind("something_new") == "other"
    for name in ("dilated_conv_dgrad_kernel<3, 64, true>",
                 "dilated_conv_wgrad_kernel<11, 1, false>", "dilated_conv_reduce_kernel",
                 "mrd_conv_dgrad_kernel<9, 2, 32, 32, true>",
                 "mrd_conv_wgrad_kernel<3, 1, 32, 1, false>"):
        assert P.kernel_kind(f"void (anonymous namespace)::{name}") == \
            "conv backward kernels (hand-written)"
