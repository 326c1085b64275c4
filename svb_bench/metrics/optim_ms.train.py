"""Host time in the program's ``update.optim`` spans (zero-filled
gradients, the clip, the learning rate, the optimizer's step) per traced
step, in ms (``program_spans.py``)."""

from svb_bench.program_spans import per_step


def read(res):
    s = per_step(res)
    return None if s is None else s["optim"]
