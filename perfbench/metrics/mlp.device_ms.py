"""Device time of MedNeXt's block MLPs a stack: E1's kernels in the trace
(``csrc/mlp.cu``: ``fused_mlp_kernel``, and ``fused_mlp_pack_kernel``, which
rounds the weights into its layout once a call). None where no such kernel
ran: a program that computes the MLPs with torch's matrix products, bias
adds and GELU (the parent of E1) reads nothing here."""

LAYER = "kernel E1 (ops/mlp.py, csrc/mlp.cu)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"
KERNELS = ("fused_mlp_",)


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0:
        return None
    return 1e3 * t / run.units
