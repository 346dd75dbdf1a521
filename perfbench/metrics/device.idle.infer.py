"""Share of the traced window in which no device operation ran."""

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    t = run.trace
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
