"""The host's own time in the step call (``make_train_step``'s
``TrainStep``: its host part and the graph's launch), mean per step: the
call's time on the host clock less the time its ``cudaGraphLaunch`` spends
in the traced window. A replay's launch waits there until the previous
replay of the same graph has run, so the call's whole time reads the
device's pace, not the host's."""

LAYER = "train step (train/step.py, infer/graph.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_mvox_s"


def read(run):
    spans = run.spans.get("enqueue")
    if not spans or run.trace is None:
        return None
    launch = sum(dur for name, _, dur in run.trace.host
                 if name == "cudaGraphLaunch") / 1e6
    return 1e3 * (sum(spans) - launch) / len(spans)
