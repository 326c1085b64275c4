"""Host time in the program's update spans (``update.gen``,
``update.disc``, ``update.map``) less their backward and optimizer spans:
the forward and the losses, per traced step, in ms (``program_spans.py``)."""

from svb_bench.program_spans import per_step


def read(res):
    s = per_step(res)
    return None if s is None else s["forward"]
