"""Batches ready in the prefetcher's queue when the step asked for one
(the program's ``feed.depth`` counter at ``feed.next``), mean per step: 0
means the step waited for the feed."""

from perfbench import program

LAYER = "data feed (data/sampler.py, data/prefetch.py)"
UNIT = "batches"
SOURCE = "program_counter"
MOVES = "train_mvox_s"


def read(run):
    snap = program.snapshot()
    depth = (snap or {}).get("counters", {}).get("feed.depth")
    return depth["mean"] if depth else None
