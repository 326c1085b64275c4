"""Share of the traced window in which no kernel ran on the card (merged
kernel intervals), in %."""


def read(res):
    if res.trace is None or res.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - res.trace.busy_s / res.trace.window_s)
