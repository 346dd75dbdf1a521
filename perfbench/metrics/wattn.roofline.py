"""W1's share of its roofline: the least time the card needs for the
shifted-window attention of every swept block (``arch/swin_unetr.work``:
FLOPs over the bf16 peak or bytes over the memory rate, whichever is
larger), over the device time of the kernel that computes it in the
trace."""

from perfbench import work

LAYER = "kernel W1 (ops/window_attn.py, csrc/window_attn.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"
KERNELS = ("window_attn_kernel",)


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0 or "wattn" not in run.work:
        return None
    return 100.0 * work.roofline_seconds(*run.work["wattn"]) * run.units / t
