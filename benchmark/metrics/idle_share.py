"""Percent of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / window."""


def read(run):
    t = run.trace
    if t is None or not t.window_ns() or not t.busy_ns():
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns())
