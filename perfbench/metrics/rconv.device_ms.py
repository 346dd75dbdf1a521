"""Device time of SwinUNETR's ResBlock convolutions a stack: the kernels
that compute them in the trace, whichever they are: R1's
(``csrc/rconv.cu``: ``rconv_kernel`` for ci a multiple of 16,
``rconv_ci1_kernel`` for enc0's ci = 1 conv, ``rconv_pack_kernel`` for the
weights, ``rconv_reduce_kernel`` for a split depth), or cuDNN's, which the
module's ``F.conv3d`` calls ran before it (``xmma_fprop_implicit_gemm``,
``implicit_convolveNd_sgemm``, and the layout transposes
``nchwToNhwcKernel``, ``nhwcToNchwKernel``). Both sides include the patch
embedding's cuDNN call (its conv and transposes), which stays on cuDNN;
cuDNN's side also includes the ResBlocks' 1x1x1 convs and the head, which
R1's side computes as matrix products (cuBLAS, not counted)."""

LAYER = ("ResBlock convs of SwinUNETR (ops/rconv.py: R1; before it cuDNN "
         "through F.conv3d)")
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "infer_mvox_s"
KERNELS = ("rconv_", "xmma_fprop_implicit_gemm", "implicit_convolveNd_sgemm",
           "nchwToNhwcKernel", "nhwcToNchwKernel")


def read(run):
    t = run.trace.kernel_seconds(KERNELS) if run.trace else 0.0
    if t <= 0:
        return None
    return 1e3 * t / run.units
