"""Device time of the sweep's glue around the net (``tiled_forward``: the
replicate pad and accumulators, the block stack, per-block normalization,
cast and core write-back): the program's ``tile_glue`` stages summed per
stack."""

from perfbench import program

LAYER = "net sweep (infer/tiles.py, models/unet3d.py, models/fused_eval.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("tile_glue")
