"""Device time of the percentile scalars (H1, H2) at the head of the sweep:
the program's ``norm`` stage (``make_infer_stages``' ``stage_net``), per
stack, from the stage marks the program captures in its graphs."""

from perfbench import program

LAYER = "net sweep (infer/tiles.py, models/unet3d.py, models/fused_eval.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("norm")
