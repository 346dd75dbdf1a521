"""Device time of the post-processing up to the size filter (sigmoids,
calibrated threshold, K1-K3, the merge when it is on): the program's
``watershed`` stage, per stack."""

from perfbench import program

LAYER = ("watershed and filter (ops/watershed.py, ops/seed.py, "
         "ops/resolve.py, ops/filter.py, ops/hist.py)")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("watershed")
