"""Weak-target synthesis: boxes/centres -> training targets (port of
``tpuseg/data/weak_targets.py``), batched on the device.

From instance centres and 3D box half-sizes only:

  peak:      max over instances of a unit gaussian at each centre (isotropic
             ``peak_sigma``, or per-instance anisotropic from the box aspect)
  fg:        1 inside any box eroded by ``margin``
  fg_weight: 0 on the ring between the eroded and the dilated boxes (those
             voxels are left out of the fg loss), 1 elsewhere

The JAX version builds an (M, D, H, W, 3) intermediate per patch; here the
instances are taken ``chunk`` at a time with running max/any, which gives
the same values at a bounded memory.
"""

from __future__ import annotations

from typing import Dict

import torch


def make_weak_targets(
    centers: torch.Tensor,     # (B, M, 3) float32, padded
    half_sizes: torch.Tensor,  # (B, M, 3) float32, padded
    valid: torch.Tensor,       # (B, M) bool
    shape,                     # (D, H, W)
    peak_sigma: float = 3.0,
    margin: float = 2.0,
    aniso_sigma: bool = False,
    chunk: int = 8,
) -> Dict[str, torch.Tensor]:
    """``{"peak", "fg", "fg_weight"}``, each (B, D, H, W) float32."""
    dev = centers.device
    b, m, _ = centers.shape
    axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in shape]
    centers = centers.float()
    half_sizes = half_sizes.float()
    if aniso_sigma:
        hsafe = torch.clamp(half_sizes, min=1e-3)
        aspect = hsafe / torch.exp(torch.log(hsafe).mean(dim=2, keepdim=True))
        sig = peak_sigma * aspect                               # (B, M, 3)

    peak = torch.zeros((b, *shape), dtype=torch.float32, device=dev)
    any_inner = torch.zeros((b, *shape), dtype=torch.bool, device=dev)
    any_outer = torch.zeros((b, *shape), dtype=torch.bool, device=dev)
    view = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    for m0 in range(0, m, chunk):
        sl = slice(m0, min(m0 + chunk, m))
        c = centers[:, sl]                                      # (B, m, 3)
        h = half_sizes[:, sl]
        v = valid[:, sl, None, None, None]
        # per-axis (pos - c) as broadcastable (B, m, D|1, H|1, W|1) pieces
        diff = [axes[a].view(view[a]) - c[:, :, a, None, None, None]
                for a in range(3)]
        if aniso_sigma:
            s = sig[:, sl]
            d2 = sum((diff[a] / s[:, :, a, None, None, None]) ** 2
                     for a in range(3))
            g = torch.exp(-0.5 * d2)
        else:
            d2 = diff[0] ** 2 + diff[1] ** 2 + diff[2] ** 2
            g = torch.exp(-0.5 * d2 / (peak_sigma ** 2))
        peak = torch.maximum(
            peak, torch.where(v, g, 0.0).amax(dim=1))
        inner_r = torch.clamp(h - margin, min=1.0)
        outer_r = h + margin
        inner = outer = v
        for a in range(3):
            delta = diff[a].abs()
            inner = inner & (delta <= inner_r[:, :, a, None, None, None])
            outer = outer & (delta <= outer_r[:, :, a, None, None, None])
        any_inner |= inner.any(dim=1)
        any_outer |= outer.any(dim=1)

    fg = any_inner.float()
    fg_weight = (any_inner | ~any_outer).float()
    return {"peak": peak, "fg": fg, "fg_weight": fg_weight}
