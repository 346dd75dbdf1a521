"""Histogram percentile normalization (port of
``tpuseg/data/normalize.histogram_percentile_scalars``).

The scalars must equal the JAX package's bit for bit: the same float32 bin
index, a ``torch.bincount`` histogram (integer counts, identical to the
TPU version's sort-based counts), and the 4096-entry float32 CDF taken
sequentially on the host — a parallel ``torch.cumsum`` on the card rounds
in another order and can move a percentile by one bin.
"""

from __future__ import annotations

import numpy as np
import torch


def histogram_percentile_scalars(vol: torch.Tensor, pcts=(1.0, 99.8),
                                 bins: int = 4096, sample_stride: int = 1):
    """``(p_lo, p_hi)`` as 0-d float32 tensors on ``vol``'s device: the
    percentiles of a ``bins``-bin histogram over every ``sample_stride``-th
    x-voxel (min and max scan the whole volume)."""
    vol = vol.float()
    lo = vol.min()
    hi = vol.max()
    span = torch.clamp(hi - lo, min=1e-12)
    sample = vol[..., ::sample_stride] if sample_stride > 1 else vol
    idx = torch.clamp(((sample - lo) / span * bins).to(torch.int32), 0,
                      bins - 1)
    hist = torch.bincount(idx.reshape(-1), minlength=bins)
    cdf = np.cumsum(hist.cpu().numpy().astype(np.float32)
                    / np.float32(sample.numel()), dtype=np.float32)
    lo_h = np.float32(lo.item())
    span_h = np.float32(span.item())

    def pct_value(p):
        b = np.searchsorted(cdf, np.float32(p / 100.0), side="left")
        val = lo_h + (np.float32(b) + np.float32(0.5)) / np.float32(bins) * span_h
        return torch.tensor(val, dtype=torch.float32, device=vol.device)

    return pct_value(pcts[0]), pct_value(pcts[1])
