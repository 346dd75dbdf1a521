"""3D max-pool peak NMS — seed detection (port of ``tpuseg/ops/peaks.py``).

Plateau handling: on exact ties inside an NMS window only the candidate with
the largest linear index survives, so the op is deterministic. The index
tie-break pools int32 indices: ``F.max_pool3d`` pools only floats, and above
2**24 voxels (the 96x512x512 stack has 25.2M) float32 cannot hold every
index, so a float pool would merge neighbouring candidates.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops.neighbors import linear_index


def radius3(radius) -> tuple:
    """Normalize an NMS radius to a per-axis (rz, ry, rx) tuple."""
    if isinstance(radius, (tuple, list)):
        rz, ry, rx = (int(r) for r in radius)
        return rz, ry, rx
    return (int(radius),) * 3


def maxpool_same(x: torch.Tensor, radius, fill) -> torch.Tensor:
    """(2r+1)-window max over (D, H, W) with SAME padding by ``fill``, as
    separable shifted maxima — exact for every dtype, integers included."""
    for axis, r in enumerate(radius3(radius)):
        if r == 0:
            continue
        n = x.shape[axis]
        pad_shape = list(x.shape)
        pad_shape[axis] = r
        pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
        padded = torch.cat([pad, x, pad], dim=axis)
        acc = padded.narrow(axis, 0, n)
        for off in range(1, 2 * r + 1):
            acc = torch.maximum(acc, padded.narrow(axis, off, n))
        x = acc
    return x


def peak_nms(peak_prob: torch.Tensor, threshold: float, radius=2) -> torch.Tensor:
    """Boolean seed mask: local maxima of ``peak_prob`` (float32) that are at
    least ``threshold``; ``radius`` is an int or per-axis (rz, ry, rx)."""
    peak = peak_prob.float()
    mx = maxpool_same(peak, radius, float("-inf"))
    cand = (peak >= threshold) & (peak >= mx)
    cand_idx = torch.where(cand, linear_index(peak.shape, peak.device), -1)
    mi = maxpool_same(cand_idx, radius, -1)
    return cand & (cand_idx == mi)
