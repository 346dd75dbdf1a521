"""Device time of MedNeXt's levels 1-4 on the tile blocks (the down
blocks, the encoder blocks below full resolution, the bottleneck, the up
blocks but the last and the decoder blocks below full resolution): the
program's ``mednext.deep`` stages summed per stack."""

from perfbench import program

LAYER = "net sweep, MedNeXt (models/mednext.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("mednext.deep")
