"""Histogram percentile normalization (port of
``tpuseg/data/normalize.histogram_percentile_scalars`` and
``histogram_percentile_normalize``).

The scalars must equal the JAX package's bit for bit: the same float32 bin
index, a ``torch.bincount`` histogram (integer counts, identical to the
TPU version's sort-based counts), and the 4096-entry float32 CDF taken
sequentially on the host — a parallel ``torch.cumsum`` on the card rounds
in another order and can move a percentile by one bin.
"""

from __future__ import annotations

import numpy as np
import torch


def bin_counts(sample, lo, span, bins: int) -> torch.Tensor:
    """(B, bins) int64 histogram of each row of the (B, n) ``sample`` between
    its row's ``lo`` and ``lo + span`` (the float32 bin index of the JAX
    package)."""
    b = sample.shape[0]
    idx = torch.clamp(((sample - lo[:, None]) / span[:, None] * bins)
                      .to(torch.int64), 0, bins - 1)
    idx = idx + torch.arange(b, device=sample.device)[:, None] * bins
    return torch.bincount(idx.reshape(-1), minlength=b * bins).reshape(b, bins)


def percentiles_from_counts(hist, n: int, lo, span, pcts,
                            bins: int) -> np.ndarray:
    """(len(pcts), B) float32 percentile values from (B, bins) counts of
    ``n`` samples a row: the float32 CDF taken sequentially on the host,
    the counts in one copy."""
    b = hist.shape[0]
    cdf = np.cumsum(np.asarray(hist.cpu()).astype(np.float32)
                    / np.float32(n), axis=1, dtype=np.float32)
    lo_h = lo.cpu().numpy().astype(np.float32)
    span_h = span.cpu().numpy().astype(np.float32)
    out = np.empty((len(pcts), b), np.float32)
    for i in range(b):
        for j, p in enumerate(pcts):
            k = np.searchsorted(cdf[i], np.float32(p / 100.0), side="left")
            out[j, i] = lo_h[i] + (np.float32(k) + np.float32(0.5)) \
                / np.float32(bins) * span_h[i]
    return out


def _percentiles(sample, lo, span, pcts, bins: int) -> np.ndarray:
    """(len(pcts), B) float32 percentile values of each row of the (B, n)
    ``sample``, histogrammed between its row's ``lo`` and ``lo + span``."""
    return percentiles_from_counts(bin_counts(sample, lo, span, bins),
                                   sample.shape[1], lo, span, pcts, bins)


def histogram_percentile_scalars(vol: torch.Tensor, pcts=(1.0, 99.8),
                                 bins: int = 4096, sample_stride: int = 1):
    """``(p_lo, p_hi)`` as 0-d float32 tensors on ``vol``'s device: the
    percentiles of a ``bins``-bin histogram over every ``sample_stride``-th
    x-voxel (min and max scan the whole volume)."""
    vol = vol.float()
    lo = vol.min()
    span = torch.clamp(vol.max() - lo, min=1e-12)
    sample = vol[..., ::sample_stride] if sample_stride > 1 else vol
    vals = _percentiles(sample.reshape(1, -1), lo[None], span[None], pcts,
                        bins)
    return tuple(torch.tensor(v[0], device=vol.device) for v in vals)


def histogram_percentile_normalize(vols: torch.Tensor, pcts=(1.0, 99.8),
                                   bins: int = 4096, eps: float = 1e-6):
    """Map each volume's [p_lo, p_hi] histogram percentiles to [0, 1],
    clipped — the per-patch form ``train.step.prepare_batch`` uses.
    ``vols``: (B, D, H, W), one histogram per volume, all B at once."""
    vols = vols.float()
    flat = vols.reshape(vols.shape[0], -1)
    lo = flat.min(dim=1).values
    span = torch.clamp(flat.max(dim=1).values - lo, min=1e-12)
    p_lo, p_hi = torch.from_numpy(_percentiles(flat, lo, span, pcts, bins)).to(
        vols.device)[:, :, None, None, None]
    return torch.clamp((vols - p_lo) / torch.clamp(p_hi - p_lo, min=eps),
                       0.0, 1.0)


def percentile_normalize(vol, pcts=(1.0, 99.8), eps: float = 1e-6):
    """Map the exact [p_lo, p_hi] percentiles of ``vol`` (a tensor, on its
    device) to [0, 1], clipped. The percentiles are two order statistics
    of one sort, linearly interpolated in float32 as ``jnp.percentile``'s
    default method does (``torch.quantile`` refuses inputs above 2**24
    elements; a 96x512x512 stack has 25.2M)."""
    vol = torch.as_tensor(vol).float()
    flat = torch.sort(vol.reshape(-1)).values
    n = flat.numel()

    def pct_value(p):
        pos = np.float32(p) / np.float32(100.0) * np.float32(n - 1)
        low = int(np.floor(pos))
        high = min(int(np.ceil(pos)), n - 1)
        w_high = np.float32(pos - np.float32(low))
        return flat[low] * float(np.float32(1.0) - w_high) \
            + flat[high] * float(w_high)

    lo, hi = pct_value(pcts[0]), pct_value(pcts[1])
    return torch.clamp((vol - lo) / torch.clamp(hi - lo, min=eps), 0.0, 1.0)
