"""Host time of the program's calls before their graphs launch (each
``program.call`` span from its start to its ``program.replay`` child's,
less its ``program.harvest`` child, the recorder's own reading of the
last replay's marks: the context walk, the key, the copy-in), summed over
a stack's calls, per stack."""

from perfbench import program

LAYER = "infer pipeline (infer/pipeline.py, infer/graph.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    prep = program.span("program.prep")
    if not prep or not run.units or prep.get("sum_ms") is None:
        return None
    return prep["sum_ms"] / run.units
