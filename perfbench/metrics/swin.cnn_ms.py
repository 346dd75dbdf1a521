"""Device time of SwinUNETR's CNN part on the tile blocks (the encoders'
and the bottleneck's ResBlocks, the up path, the head): the program's
``swin.cnn`` stages summed per stack."""

from perfbench import program

LAYER = "net sweep, SwinUNETR (models/swin_unetr.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("swin.cnn")
