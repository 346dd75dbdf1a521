"""K6's share of its roofline: the least time the card needs for the
3x3x3 convs K6 runs in a step (``work.k6_work``: six full-resolution
forwards and five input gradients), over the device time of its kernels in
the trace."""

from perfbench import work

LAYER = "kernel K6 (ops/convtrain.py, csrc/convtrain.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_mvox_s"
KERNELS = ("conv3x3_kernel", "conv3x3_mma_kernel")


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0 or "k6" not in run.work:
        return None
    return 100.0 * work.roofline_seconds(*run.work["k6"]) * run.units / t
