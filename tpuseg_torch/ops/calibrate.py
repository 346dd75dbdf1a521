"""Threshold calibration for box-supervised foreground maps (port of
``tpuseg/ops/calibrate.py``).

Box supervision inflates the learned foreground: the net is trained on box
interiors, and an axis-aligned box has ~1.9x the volume of its inscribed
ellipsoid, so at ``fg_threshold=0.5`` predicted masks are ~2x too large and
miss IoU 0.5. The fix is the threshold whose predicted foreground VOLUME
matches the expected instance volume, which the weak annotations give
(sum of ellipsoid volumes from box half-sizes).

``threshold_for_fraction`` runs on the map's device and returns a 0-d
tensor there, with no host read; the other helpers are numpy copies of the
JAX package's (that module imports JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.ops.hist import bin_counts, bin_counts_plain


def threshold_for_fraction(prob: torch.Tensor, fraction: float,
                           bins: int = 4096, sample_stride: int = 1,
                           plain: bool = False) -> torch.Tensor:
    """Threshold t (0-d float32) such that mean(prob >= t) ~= fraction, from
    a ``bins``-bin histogram of every ``sample_stride``-th x-voxel: the
    JAX version's arithmetic (exact integer counts, float32 fractions).
    ``plain=True`` takes the histogram with H1's twin on any device."""
    hist, n = sampled_fg_counts(prob.float(), sample_stride, bins, plain)
    return threshold_from_counts(hist, n, fraction)


def sampled_fg_counts(prob: torch.Tensor, sample_stride: int = 1,
                      bins: int = 4096, plain: bool = False):
    """``(counts, n)``: the int64 ``bins``-bin histogram of every
    ``sample_stride``-th x voxel of the probabilities ``prob`` (in [0, 1]),
    the voxels the calibration sees, and their number: H1 under its
    calibration rule on the card (``ops/hist.py``), its twin with
    ``plain=True``. x is never split, so the cores of shards or chunks
    sample the whole map's voxels and their summed counts are the whole
    map's."""
    if sample_stride > 1:
        prob = prob[..., ::sample_stride]
    counts = bin_counts_plain if plain else bin_counts
    return (counts(prob.float().reshape(1, -1), bins=bins,
                   rule="calibrate")[0], prob.numel())


def threshold_from_counts(hist: torch.Tensor, n: int,
                          fraction: float) -> torch.Tensor:
    """The threshold of ``threshold_for_fraction`` from a histogram of
    ``n`` probabilities (exact integer counts, float32 fractions): the
    sharded path sums its shards' counts into one."""
    bins = hist.numel()
    # survival fraction: share of voxels with prob >= bin edge
    tail = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,)).float() \
        / n
    b = (tail >= fraction).sum().float()
    return torch.clamp((b - 0.5) / bins, 0.0, 1.0)


def expected_fg_fraction(half_sizes: np.ndarray, volume_voxels: int,
                         valid: np.ndarray | None = None) -> float:
    """Fraction of the volume occupied by the annotated ellipsoids:
    sum(4/3 pi * prod(half_sizes)) / volume."""
    h = np.asarray(half_sizes, np.float64)
    if valid is not None:
        h = h[np.asarray(valid, bool)]
    vol = (4.0 / 3.0) * np.pi * np.prod(h, axis=-1).sum()
    return float(vol / volume_voxels)


def adaptive_upper_pct(fg_fraction: float, default_upper: float = 99.8,
                       headroom: float = 10.0, cap: float = 99.995) -> float:
    """Density-aware upper normalization percentile: clips at most
    ``fg_fraction / headroom`` of the voxels, never below ``default_upper``
    and never above ``cap`` (sparse volumes would otherwise saturate
    instance cores into flat plateaus that split into several peaks)."""
    want = 100.0 * (1.0 - float(fg_fraction) / headroom)
    return float(min(max(default_upper, want), cap))


def nms_radius_from_half_sizes(half_sizes: np.ndarray, base: int = 2,
                               valid: np.ndarray | None = None) -> tuple:
    """Per-axis NMS footprint from the annotations' box half-sizes:
    ``clamp(round(base * median(hs_axis) / max_axis_median), 1, base)``
    (a smaller z footprint for z-compressed stacks)."""
    h = np.asarray(half_sizes, np.float64)
    if valid is not None:
        h = h[np.asarray(valid, bool)]
    med = np.median(h, axis=0)
    scale = med / med.max()
    return tuple(int(np.clip(round(base * s), 1, base)) for s in scale)
