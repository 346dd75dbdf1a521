"""Host time of the prefetch worker's upload of a batch (its ``feed.put``
span: pinning and the copies' enqueue), mean per batch."""

from perfbench import program

LAYER = "data feed (data/sampler.py, data/prefetch.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_mvox_s"


def read(run):
    put = program.span("feed.put")
    return put.get("mean_ms") if put else None
