"""Device time of MedNeXt's full-resolution level on the tile blocks (the
stem, the level-0 encoder blocks, the last up block, the level-0 decoder
blocks and the head): the program's ``mednext.full`` stages summed per
stack."""

from perfbench import program

LAYER = "net sweep, MedNeXt (models/mednext.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("mednext.full")
