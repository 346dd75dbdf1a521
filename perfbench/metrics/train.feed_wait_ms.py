"""Host time ``BatchPrefetcher.next()`` blocks, mean per step."""

LAYER = "data feed (data/sampler.py, data/prefetch.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "train_mvox_s"


def read(run):
    spans = run.spans.get("feed_wait")
    return 1e3 * sum(spans) / len(spans) if spans else None
