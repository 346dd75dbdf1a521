"""Device time of SwinUNETR's InstanceNorm a stack: the kernels that
implement the ResBlocks' normalizations in the trace, whichever they are:
torch's batch-norm kernels, which ``torch.instance_norm`` runs (statistics,
then normalize; the LeakyReLU and add passes run outside them), or N1's
pair (``csrc/instnorm.cu``: statistics, then normalize, add and
activate)."""

LAYER = ("InstanceNorm of the ResBlocks (ops/instnorm.py: N1; before it "
         "torch's batch-norm kernels, with the LeakyReLU and add passes "
         "outside)")
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"
KERNELS = ("batch_norm_collect_statistics", "batch_norm_transform_input",
           "instnorm_stats_kernel", "instnorm_apply_kernel")


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0:
        return None
    return 1e3 * t / run.units
