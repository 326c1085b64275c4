"""Host time in the program's ``train.sync`` spans (the trainer's two
synchronisations) per traced step, in ms (``program_spans.py``). Where
the host sets the pace it falls as the host slows, and rises as it gets
faster."""

from svb_bench.program_spans import per_step


def read(res):
    s = per_step(res)
    return None if s is None else s["sync_wait"]
