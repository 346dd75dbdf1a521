"""D1's share of its roofline: the least time the card needs for the
depthwise convs of every swept block (``arch/mednext.work``: FLOPs over the
bf16 peak or bytes over the memory rate, whichever is larger: a tensor-core
form would be bound by bytes), over the device time of the kernels that
compute them in the trace."""

from perfbench import work

LAYER = "kernel D1 (ops/dwconv.py, csrc/dwconv.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"
KERNELS = ("dwconv_",)


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0 or "dwconv" not in run.work:
        return None
    return 100.0 * work.roofline_seconds(*run.work["dwconv"]) * run.units / t
