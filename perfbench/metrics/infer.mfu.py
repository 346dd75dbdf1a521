"""The whole call's share of the card's bf16 peak: the U-Net's forward
FLOPs over the stack's voxels (useful voxels only: halo recompute is
waste), per stack, over the host-clock time per stack in the window."""

from perfbench import work

LAYER = "model step (whole stack)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "infer_mvox_s"


def read(run):
    if not run.units or "model_flops" not in run.work:
        return None
    return (100.0 * run.work["model_flops"] * run.units
            / (run.window_s * work.BF16_FLOPS))
