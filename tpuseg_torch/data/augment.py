"""3D augmentation on the device (port of ``tpuseg/data/augment.py``).

Each augmentation is split in two: ``draw_*`` takes its random parameters
from an explicit ``torch.Generator`` (on the device the patch lives on, so
nothing waits for the host), ``apply_*`` applies given parameters. Torch
cannot reproduce JAX's PRNG stream, so the port matches the JAX package on
the apply half with the parameters fixed; the draws follow the same
distributions.

Spatial ops (flips on all three axes, H<->W transpose when the patch is
square) act on the image and every spatial target alike; intensity ops
(scale/shift/noise jitter) on the image only. Flags stay 0-d device
tensors and select with ``torch.where``, as ``jnp.where`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def draw_augment_params(generator: torch.Generator, shape) -> dict:
    """Random parameters of :func:`apply_augment` for a (D, H, W) patch:
    flips (3,) bool, swap () bool, scale, shift () float32, noise (D, H, W)
    float32 — the distributions of ``augment_patch``."""
    dev = generator.device
    u = torch.rand(6, generator=generator, device=dev)
    noise = torch.randn(tuple(shape), generator=generator, device=dev)
    return {
        "flips": u[:3] < 0.5,
        "swap": u[3] < 0.5,
        "scale": 1.0 + 0.2 * (2.0 * u[4] - 1.0),
        "shift": 0.1 * (2.0 * u[5] - 1.0),
        "noise": 0.02 * noise,
    }


def apply_augment(params: dict, image: torch.Tensor,
                  targets: Dict[str, torch.Tensor], intensity: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``augment_patch`` with given parameters; image and targets (D, H, W)."""
    square = image.shape[1] == image.shape[2]
    flips, swap = params["flips"], params["swap"]

    def spatial(x):
        for axis in range(3):
            x = torch.where(flips[axis], x.flip(axis), x)
        if square:
            x = torch.where(swap, x.transpose(1, 2), x)
        return x

    image = spatial(image)
    targets = {k: spatial(v) for k, v in targets.items()}
    if intensity:
        image = torch.clamp(image * params["scale"] + params["shift"]
                            + params["noise"], 0.0, 1.0)
    return image, targets


def draw_zscale(generator: torch.Generator,
                scale_range: Tuple[float, float]) -> torch.Tensor:
    """The z-scale factor ``s ~ U(lo, hi)`` of :func:`apply_zscale`, 0-d."""
    lo, hi = scale_range
    u = torch.rand((), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def apply_zscale(s: torch.Tensor, image: torch.Tensor, centers: torch.Tensor,
                 half_sizes: torch.Tensor, valid: torch.Tensor):
    """``zscale_patch`` with a given factor ``s``: squash/stretch a (D, H, W)
    patch along z about its centre (linear, edge-clamped resampling) and
    transform its (M, 3) annotations to match.

    Returns ``(image, centers, half_sizes, valid, z_weight)``: ``z_weight``
    (D,) is 0 on output planes whose source coordinate falls outside
    [0, D-1] (edge-replicated planes, left out of the fg loss); ``valid``
    also drops annotations whose transformed centre left the patch."""
    d = image.shape[0]
    c = (d - 1) / 2.0
    z_in = c + (torch.arange(d, dtype=torch.float32, device=image.device)
                - c) / s
    z_weight = ((z_in >= 0.0) & (z_in <= d - 1.0)).float()
    z0 = torch.clamp(torch.floor(z_in).to(torch.int64), 0, d - 1)
    z1 = torch.clamp(z0 + 1, 0, d - 1)
    w = torch.clamp(z_in - z0.float(), 0.0, 1.0)[:, None, None]
    image = image[z0] * (1.0 - w) + image[z1] * w
    cz = c + (centers[:, 0] - c) * s
    centers = torch.cat([cz[:, None], centers[:, 1:]], dim=1)
    half_sizes = torch.cat([(half_sizes[:, 0] * s)[:, None],
                            half_sizes[:, 1:]], dim=1)
    valid = valid & (cz >= 0.0) & (cz <= d - 1.0)
    return image, centers, half_sizes, valid, z_weight
