"""Device time of the task's ``gen_step`` (CUDA events around it; the
generator's forward, losses, backward, clip and optimizer step) per step,
in ms."""


def read(res):
    ms = res.record.get("gen_step_ms")
    return sum(ms) / len(ms) if ms else None
