"""Host time in the program's ``task.prep_batch`` spans (the batch's move
to the card) per traced step, in ms (``program_spans.py``)."""

from svb_bench.program_spans import per_step


def read(res):
    s = per_step(res)
    return None if s is None else s["prep"]
