"""Histogram percentile normalization (port of
``tpuseg/data/normalize.histogram_percentile_scalars`` and
``histogram_percentile_normalize``).

The scalars must equal the JAX package's bit for bit: the same float32 bin
index, integer counts (identical to the TPU version's sort-based counts),
and the 4096-entry float32 CDF summed in bin order (a parallel
``torch.cumsum`` rounds in another order and can move a percentile by one
bin). On the card both run as kernels of their own (``ops/hist.py``: H1
the counts, H2 the CDF and its search), so the scalars stay on the device
and the host reads nothing; on the CPU the twins run.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.ops import hist


def bin_counts(sample, lo, span, bins: int) -> torch.Tensor:
    """(B, bins) int64 histogram of each row of the (B, n) ``sample`` between
    its row's ``lo`` and ``lo + span`` (the float32 bin index of the JAX
    package)."""
    return hist.bin_counts(sample, lo, span, bins, rule="normalize")


def percentiles_from_counts(counts, n: int, lo, span, pcts,
                            bins: int) -> torch.Tensor:
    """(len(pcts), B) float32 percentile values, on ``counts``' device,
    from (B, bins) counts of ``n`` samples a row: the float32 CDF summed
    in bin order."""
    return hist.percentiles(counts, n, lo, span, pcts, bins)


def _percentiles(sample, lo, span, pcts, bins: int) -> torch.Tensor:
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
    return tuple(vals[:, 0])


def histogram_percentile_normalize(vols: torch.Tensor, pcts=(1.0, 99.8),
                                   bins: int = 4096, eps: float = 1e-6):
    """Map each volume's [p_lo, p_hi] histogram percentiles to [0, 1],
    clipped — the per-patch form ``train.step.prepare_batch`` uses.
    ``vols``: (B, D, H, W), one histogram per volume, all B at once."""
    vols = vols.float()
    flat = vols.reshape(vols.shape[0], -1)
    lo = flat.min(dim=1).values
    span = torch.clamp(flat.max(dim=1).values - lo, min=1e-12)
    p_lo, p_hi = _percentiles(flat, lo, span, pcts, bins)[:, :, None, None,
                                                          None]
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
