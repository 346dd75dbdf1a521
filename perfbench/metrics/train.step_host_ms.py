"""The host's own time in a train step call: the program's ``step.call``
span less its ``program.replay`` child (the graph's launch, which waits
for the previous replay), mean per step."""

from perfbench import program

LAYER = "train step (train/step.py, infer/graph.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_mvox_s"


def read(run):
    snap = program.snapshot()
    call = program.span("step.call", snap)
    replay = program.span("program.replay", snap)
    if not call or not replay or call.get("sum_ms") is None:
        return None
    return (call["sum_ms"] - replay["sum_ms"]) / call["count"]
