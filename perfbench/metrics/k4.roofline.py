"""K4's share of its roofline: the least time the card needs for the three
full-resolution ConvBlocks of every swept block (``work.k4_work``: FLOPs
over the bf16 peak or bytes over the memory rate, whichever is larger),
over the device time of the kernels that compute them in the trace."""

from perfbench import work

LAYER = "kernel K4 (ops/convblock.py, csrc/convblock.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"
KERNELS = ("convblock_kernel", "convblock_mma_kernel")


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0 or "k4" not in run.work:
        return None
    return 100.0 * work.roofline_seconds(*run.work["k4"]) * run.units / t
