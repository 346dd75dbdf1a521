"""Device memory the live captured graphs reserved at their captures (the
graph pool), from the program's gauges (``pool_bytes`` over the programs
that hold graphs)."""

from perfbench import program

LAYER = "infer pipeline (infer/pipeline.py, infer/graph.py)"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "infer_mvox_s"


def read(run):
    totals = (program.snapshot() or {}).get("gauge_totals")
    if not totals or not totals.get("graphs"):
        return None
    return totals["pool_bytes"] / 2 ** 30
