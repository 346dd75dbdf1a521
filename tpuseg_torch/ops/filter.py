"""Instance sizes, the small-object filter and the compact relabel (port of
``tpuseg/ops/filter.py``).

The TPU package computes the fused filter and relabel with two sorts to
dodge slow TPU random access; here it is one ``torch.unique`` (sorted, with
inverse and counts) and one gather, on any device. Sizes come from one
``torch.bincount`` over the label space, which is bounded by the voxel count
(labels are root linear indices + 1).
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops.peaks import radius3


def size_filter_and_compact(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Drop instances smaller than ``min_size`` voxels and number the kept
    labels 1..K, ascending in original label value; background stays 0."""
    uniq, inverse, counts = torch.unique(labels.reshape(-1), sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    keep = (uniq > 0) & (counts >= min_size)
    rank = torch.cumsum(keep.to(torch.int64), 0)
    remap = torch.where(keep, rank, 0).to(labels.dtype)
    return remap[inverse].reshape(labels.shape)


def label_sizes(labels: torch.Tensor) -> torch.Tensor:
    """int32 per-voxel size of the instance the voxel belongs to (the
    background's count at label 0). ``labels`` lie in 0..N for N voxels;
    the histogram is (N+1,) int32, as in the JAX package."""
    flat = labels.reshape(-1).to(torch.int64)
    counts = torch.bincount(flat, minlength=flat.numel() + 1).to(torch.int32)
    return counts[flat].reshape(labels.shape)


def size_filter(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero out instances with fewer than ``min_size`` voxels."""
    keep = (labels > 0) & (label_sizes(labels) >= min_size)
    return torch.where(keep, labels, 0)


def max_seed_count(shape, radius) -> int:
    """Upper bound on peak-NMS seeds: two surviving seeds are more than
    that axis's radius apart on some axis (plateaus are broken by index),
    so each cell of prod(radius_axis + 1) voxels holds at most one."""
    cells = 1
    for s, r in zip(shape, radius3(radius)):
        cells *= -(-s // (r + 1))
    return cells
