"""Kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) of the
profile that start inside the program's ``train.step`` spans, per traced
step (``program_spans.py``)."""

from svb_bench.program_spans import per_step


def read(res):
    s = per_step(res)
    return None if s is None else s["launches"]
