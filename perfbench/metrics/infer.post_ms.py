"""Device time of the post-processing (``stage_post``: sigmoid, calibrated
threshold, watershed, size filter), mean per stack, between CUDA events."""

LAYER = ("watershed and filter (ops/watershed.py, ops/seed.py, "
         "ops/resolve.py, ops/filter.py, ops/hist.py)")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    spans = run.spans.get("post")
    return 1e3 * sum(spans) / len(spans) if spans else None
