"""Device time of SwinUNETR's transformer part on the tile blocks (patch
embedding, the four Swin stages with their mergings, the hidden-output
norms): the program's ``swin.transformer`` stages summed per stack."""

from perfbench import program

LAYER = "net sweep, SwinUNETR (models/swin_unetr.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    return program.stage_ms("swin.transformer")
