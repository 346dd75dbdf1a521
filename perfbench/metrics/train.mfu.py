"""The whole step's share of the card's bf16 peak: three times the U-Net's
forward FLOPs (forward, input and weight gradients) over the step's
voxels, per step, over the host-clock time per step in the window."""

from perfbench import work

LAYER = "model step (train)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_mvox_s"


def read(run):
    if not run.units or "model_flops" not in run.work:
        return None
    return (100.0 * run.work["model_flops"] * run.units
            / (run.window_s * work.BF16_FLOPS))
