"""The share of the traced window in which the card runs no operation (the
union of the device intervals, so overlapping operations count once)."""

UNIT = "%"
LAYER = "device"
MOVES = "step_ms"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
