"""The plain reference that decides ``correct``: plain PyTorch and numpy,
float32, TF32 off on the card. It imports nothing of the program and takes
nothing the program made: it is handed the state dicts, volumes and raw
patches the benchmark made, works everything else out again, and reads the
program's outputs only to judge them."""

import torch


def exact_float32() -> None:
    """Float32 convolutions and matrix products in float32 (an H100 would
    otherwise take TF32 for them)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
