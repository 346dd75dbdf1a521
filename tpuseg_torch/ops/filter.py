"""Size filter + compact relabel (port of ``tpuseg/ops/filter.py``).

The TPU package computes this with two sorts to dodge slow TPU random
access; here it is one ``torch.unique`` (sorted, with inverse and counts) and
one gather, on any device.
"""

from __future__ import annotations

import torch


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
