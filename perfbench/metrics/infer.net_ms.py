"""Device time of the net on the tile blocks (``model(blocks)`` in
``tiled_forward``): the program's ``net`` stages summed per stack."""

from perfbench import program

LAYER = "net sweep (infer/tiles.py, models/unet3d.py, models/fused_eval.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("net")
