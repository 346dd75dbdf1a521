"""Compact relabel (port of ``tpuseg/ops/relabel.py``): sparse root-index
labels to dense 1..K, in one ``torch.unique`` with inverse."""

from __future__ import annotations

import torch


def compact_relabel(labels: torch.Tensor) -> torch.Tensor:
    """Renumber labels to 1..K preserving the order of label values; 0 stays
    0."""
    uniq, inverse = torch.unique(labels.reshape(-1), sorted=True,
                                 return_inverse=True)
    rank = torch.cumsum((uniq > 0).to(torch.int64), 0)
    remap = torch.where(uniq > 0, rank, 0).to(labels.dtype)
    return remap[inverse].reshape(labels.shape)
