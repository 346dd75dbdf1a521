"""The 3D U-Net of the Dong et al. configurations, behind the harness's
architecture seam (``cells.load_arch``).

The program's model is ``tpuseg_torch.models.UNet3D`` built from the port's
``ModelConfig``, into which every key of the configuration's ``model``
group goes. Its state: LeCun-normal conv kernels drawn on the device from
a seed in one call, zero biases, BatchNorm affines (1, 0) and initial
running statistics (0, 1), in the program's parameter names; the running
statistics are the state the trainer keeps apart from the parameters. The
plain float32 reference is ``reference/unet.forward``; the work counts are
``work.py``'s.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import unet
from perfbench.work import k4_work, k6_work, unet_convs, unet_flops_per_voxel

#: what the trained weights' cache key hashes for this architecture
SOURCES = ("arch/unet3d.py", "work.py", "reference/unet.py")


def program_overrides(model: dict) -> dict:
    """Every key of the ``model`` group, as a ``model.*`` setting."""
    return {f"model.{k}": v for k, v in model.items()}


def build(cfg, model: dict, device) -> torch.nn.Module:
    from tpuseg_torch.models import UNet3D

    return UNet3D(cfg.model).to(device)


def state_shapes(model: dict) -> dict:
    """Parameter and buffer name -> shape, the program's names."""
    out = {}
    for name, k, ci, co, _ in unet_convs(model["features"],
                                         model["in_channels"],
                                         model["head_features"]):
        out[f"{name}.weight"] = (co, ci, k, k, k)
        block, _, conv = name.rpartition(".")
        if conv in ("conv0", "conv1"):
            norm = f"{block}.norm{conv[-1]}"
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{norm}.{leaf}"] = (co,)
        else:
            out[f"{name}.bias"] = (co,)
    return out


def init_state(model: dict, seed: int, device) -> dict:
    shapes = state_shapes(model)
    kernels = [k for k in shapes if len(shapes[k]) == 5]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(math.prod(shapes[k]) for k in kernels),
                       generator=g, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if len(shape) == 5:
            n = math.prod(shape)
            out[k] = flat[at:at + n].view(shape) / math.sqrt(
                math.prod(shape[1:]))
            at += n
        elif k.endswith(("weight", "running_var")):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def is_statistic(name: str) -> bool:
    """BatchNorm's running statistics."""
    return "running" in name


def forward(p: dict, x: torch.Tensor, model: dict, train: bool = False,
            stats: dict | None = None, quant=None) -> dict:
    return unet.forward(p, x, len(model["features"]), train=train,
                        stats=stats, quant=quant)


def flops_per_voxel(model: dict) -> float:
    return unet_flops_per_voxel(model["features"], model["in_channels"],
                                model["head_features"])


def work(model: dict, kind: str, **shapes) -> dict:
    """K4's work over one stack (``shape``, ``tile``, ``halo``) for
    inference, K6's in one step (``batch``, ``patch``) for training."""
    if kind == "infer":
        return {"k4": k4_work(model, shapes["shape"], shapes["tile"],
                              shapes["halo"])}
    return {"k6": k6_work(model, shapes["batch"], shapes["patch"])}
