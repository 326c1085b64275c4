"""Host time in the program's ``update.backward`` spans (``zero_grad`` and
autograd's backward) per traced step, in ms (``program_spans.py``)."""

from svb_bench.program_spans import per_step


def read(res):
    s = per_step(res)
    return None if s is None else s["backward"]
