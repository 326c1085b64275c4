"""Device time of the task's ``disc_step`` (CUDA events around it) per
step, in ms."""


def read(res):
    ms = res.record.get("disc_step_ms")
    return sum(ms) / len(ms) if ms else None
