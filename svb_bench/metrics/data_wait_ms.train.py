"""Host time in ``next(loader)`` per step of the window, in ms."""


def read(res):
    w = res.record.get("data_wait_s")
    return 1e3 * sum(w) / len(w) if w else None
