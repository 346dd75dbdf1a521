"""Device time of the size filter and compaction (H3): the program's
``filter`` stage, per stack."""

from perfbench import program

LAYER = ("watershed and filter (ops/watershed.py, ops/seed.py, "
         "ops/resolve.py, ops/filter.py, ops/hist.py)")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("filter")
