"""Instance sizes, the small-object filter and the compact relabel (port of
``tpuseg/ops/filter.py``).

Sizes come from one (N+1,) label histogram (``ops/hist.label_counts``, H3
on the card: labels are root linear indices + 1, so they lie in 0..N for N
voxels). The filter and the relabel are then a rank table and one gather,
as in the JAX package's ``impl="scatter"`` schedule (its default two-sort
schedule dodges slow TPU random access and gives the same labels). Nothing
here reads the number of labels on the host.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops.hist import label_counts, label_counts_plain
from tpuseg_torch.ops.peaks import radius3


def size_filter_and_compact(labels: torch.Tensor, min_size: int,
                            plain: bool = False) -> torch.Tensor:
    """Drop instances smaller than ``min_size`` voxels and number the kept
    labels 1..K, ascending in original label value; background stays 0.
    On the card ``labels`` must lie in 0..N for N voxels, as the
    watershed's root linear index + 1 does: H3's counts and the rank table
    have N + 1 entries, and a larger label would index past them. H3's
    twin, which CPU tensors take, also takes any larger non-negative label.
    ``plain=True`` counts with the twin on any device (the card's check of
    the kernel)."""
    counts = (label_counts_plain if plain else label_counts)(labels)
    # only labels present are ranked (H3 leaves the background's count 0),
    # so min_size <= 0 keeps every instance and still numbers them 1..K
    keep = (counts > 0) & (counts >= min_size)
    rank = torch.cumsum(keep, 0, dtype=torch.int32)
    remap = torch.where(keep, rank, 0).to(labels.dtype)
    return _gather(remap, labels)


def label_sizes(labels: torch.Tensor) -> torch.Tensor:
    """int32 per-voxel size of the instance the voxel belongs to (the
    background's count at label 0). ``labels`` lie in 0..N for N voxels;
    the histogram is (N+1,) int32, as in the JAX package."""
    counts = label_counts(labels)
    counts[0].copy_(labels.numel() - counts.sum(dtype=torch.int64))
    return _gather(counts, labels)


def _gather(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``table[labels]`` in ``labels``' shape."""
    return table.index_select(0, labels.reshape(-1)).reshape(labels.shape)


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
