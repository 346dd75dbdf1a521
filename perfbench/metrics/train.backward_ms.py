"""Device time of the train step's backward pass: the program's ``backward``
stage, per step (summed over its microbatches), from the stage marks
captured in the step's graph; steps whose marks the next replay overwrote
before they were read are left out."""

from perfbench import program

LAYER = "train step (train/step.py, infer/graph.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_mvox_s"


def read(run):
    return program.stage_ms("backward")
