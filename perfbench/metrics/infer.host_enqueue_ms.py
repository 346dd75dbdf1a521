"""Host time from the call into ``make_infer_fn``'s program to its return,
mean per stack: what the host spends enqueueing a replay (a span the
benchmark takes around the call)."""

LAYER = "infer pipeline (infer/pipeline.py, infer/graph.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "infer_mvox_s"


def read(run):
    spans = run.spans.get("enqueue")
    return 1e3 * sum(spans) / len(spans) if spans else None
