"""Device time of the net sweep (``make_infer_stages``' ``stage_net``, the
first of the staged program's two graphs), mean per stack, between CUDA
events recorded around it."""

LAYER = "net sweep (infer/tiles.py, models/unet3d.py, models/fused_eval.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_mvox_s"


def read(run):
    spans = run.spans.get("sweep")
    return 1e3 * sum(spans) / len(spans) if spans else None
