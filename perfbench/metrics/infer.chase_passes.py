"""K2 passes run per stack (``ops.resolve.passes_run`` of the chase's
gates after each call), mean: the passes enqueued are fixed, the ones that
run follow the basins' depth."""

LAYER = ("watershed and filter (ops/watershed.py, ops/seed.py, "
         "ops/resolve.py, ops/filter.py, ops/hist.py)")
UNIT = "passes"
SOURCE = "program_counter"
MOVES = "infer_mvox_s"


def read(run):
    n = run.counters.get("chase_passes")
    return sum(n) / len(n) if n else None
