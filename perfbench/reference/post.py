"""Plain post-processing and normalization: the semantics the inference
configurations state, written out in torch and numpy tensor code.

* :func:`percentile_scalars`: a 4096-bin histogram of every
  ``stride``-th x-voxel between the volume's minimum and maximum (float32
  bin index, truncated), its float32 CDF summed in bin order, the first bin
  whose CDF reaches ``p / 100``, and the bin's centre;
* :func:`threshold_for_fraction`: the calibrated foreground threshold: a
  4096-bin histogram of ``prob * 4096`` (every ``stride``-th x-voxel), the
  survival fraction of each bin edge in float32, ``(b - 0.5) / 4096`` with
  ``b`` the bins whose survival reaches the target fraction;
* :func:`watershed`: seeds are the peak map's local maxima over a
  (2r+1)-window at or above the peak threshold, ties inside a window going
  to the largest linear index, inside the foreground (``fg >= threshold``);
  every foreground voxel points at the steepest of itself and its six
  neighbours in the foreground (peak value, then the larger linear index),
  seeds at themselves; a voxel whose chain reaches its root within
  ``h0 + 8 * chase_passes`` steps takes the root's label (its linear index
  + 1) if the root is a seed, others stay 0; then a lockstep flood over the
  foreground, at most ``flood_iters`` steps: an unlabelled foreground voxel
  takes the label of its labelled neighbour of highest foreground
  probability (then the larger linear index);
* :func:`size_filter_and_compact`: labels of fewer than ``min_size`` voxels
  dropped, the rest numbered 1..K in ascending label order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BINS = 4096


def percentile_scalars(vol: torch.Tensor, pcts, stride: int = 1) -> tuple:
    """``(p_lo, p_hi)`` as float32 numpy scalars."""
    vol = vol.float()
    lo = vol.min()
    span = torch.clamp(vol.max() - lo, min=1e-12)
    sample = vol[..., ::stride].reshape(-1)
    idx = torch.clamp(((sample - lo) / span * BINS).long(), 0, BINS - 1)
    counts = torch.bincount(idx, minlength=BINS).cpu().numpy()
    cdf = np.cumsum(counts.astype(np.float32) / np.float32(sample.numel()),
                    dtype=np.float32)
    lo_h, span_h = np.float32(lo.item()), np.float32(span.item())
    out = []
    for p in pcts:
        k = np.searchsorted(cdf, np.float32(p / 100.0), side="left")
        out.append(lo_h + (np.float32(k) + np.float32(0.5))
                   / np.float32(BINS) * span_h)
    return tuple(out)


def calibration(half_sizes, n_voxels: int, default_upper: float,
                base: int = 2, headroom: float = 10.0,
                cap: float = 99.995) -> dict:
    """The configuration's calibration from weak annotations: the fg
    ``fraction`` (the annotated ellipsoids' share of the volume), the
    ``upper`` normalization percentile (clipping at most a tenth of that
    share, within [default, cap]) and the per-axis NMS ``radius``
    (``base`` x each axis's median half-size over the largest, rounded,
    within [1, base])."""
    h = np.asarray(half_sizes, np.float64)
    frac = float((4.0 / 3.0) * np.pi * np.prod(h, axis=-1).sum() / n_voxels)
    upper = float(min(max(default_upper, 100.0 * (1.0 - frac / headroom)),
                      cap))
    med = np.median(h, axis=0)
    radius = tuple(int(np.clip(round(base * v), 1, base))
                   for v in med / med.max())
    return {"fraction": frac, "upper": upper, "radius": radius}


def normalizer(p_lo, p_hi):
    """The per-block map ``clamp((b - p_lo) / max(p_hi - p_lo, 1e-6), 0,
    1)`` in float32."""
    span = max(np.float32(p_hi) - np.float32(p_lo), np.float32(1e-6))
    lo, span = float(p_lo), float(np.float32(span))
    return lambda b: torch.clamp((b - lo) / span, 0.0, 1.0)


def threshold_for_fraction(prob: torch.Tensor, fraction: float,
                           stride: int = 1) -> torch.Tensor:
    """The calibrated threshold, a 0-d float32 tensor on prob's device."""
    x = prob.float()[..., ::stride].reshape(-1)
    idx = torch.clamp((x * BINS).long(), 0, BINS - 1)
    counts = torch.bincount(idx, minlength=BINS).cpu().numpy()
    tail = (np.cumsum(counts[::-1])[::-1].astype(np.float32)
            / np.float32(x.numel()))
    b = np.float32((tail >= np.float32(fraction)).sum())
    thr = np.clip((b - np.float32(0.5)) / np.float32(BINS), 0.0, 1.0)
    return torch.tensor(thr, dtype=torch.float32, device=prob.device)


def _window_max(x: torch.Tensor, radius) -> torch.Tensor:
    r = tuple(radius)
    return F.max_pool3d(x[None, None], tuple(2 * a + 1 for a in r),
                        stride=1, padding=r)[0, 0]


def seeds(peak: torch.Tensor, threshold, radius) -> torch.Tensor:
    """Peak-NMS seed mask of the float32 peak map."""
    cand = (peak >= threshold) & (peak >= _window_max(peak, radius))
    idx = torch.arange(peak.numel(), device=peak.device,
                       dtype=torch.float64).view(peak.shape)
    # float64 holds every linear index exactly; -1 marks no candidate
    cidx = torch.where(cand, idx, -1.0)
    return cand & (cidx == _window_max(cidx, radius))


def _neighbours(x: torch.Tensor, fill):
    """The six face neighbours of every voxel, ``fill`` outside."""
    p = F.pad(x[None, None], (1, 1, 1, 1, 1, 1), value=fill)[0, 0]
    d, h, w = x.shape
    for a in range(3):
        for s in (2, 0):
            sl = [slice(1, 1 + d), slice(1, 1 + h), slice(1, 1 + w)]
            sl[a] = slice(s, s + x.shape[a])
            yield p[tuple(sl)]


def watershed(fg_prob, peak_prob, peak_threshold, fg_threshold, radius,
              flood_iters: int = 96, h0: int = 8,
              chase_passes: int = 128) -> torch.Tensor:
    """int32 root-index labels (module docstring)."""
    fgp = fg_prob.float()
    peak = peak_prob.float()
    if isinstance(fg_threshold, torch.Tensor):
        fg_threshold = fg_threshold.float()
    fg = fgp >= fg_threshold
    seed = seeds(peak, peak_threshold, radius) & fg
    n = peak.numel()
    idx = torch.arange(n, device=peak.device).view(peak.shape)
    pot = torch.where(fg, peak, float("-inf"))
    best_pot, best_idx = pot, idx
    for npot, nidx in zip(_neighbours(pot, float("-inf")),
                          _neighbours(idx, -1)):
        better = (npot > best_pot) | ((npot == best_pot) & (nidx > best_idx))
        best_pot = torch.where(better, npot, best_pot)
        best_idx = torch.where(better, nidx, best_idx)
    parent = torch.where(fg & ~seed, best_idx, idx).reshape(-1)
    depth = (parent != idx.reshape(-1)).long()
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        depth = depth + depth[parent]
        parent = parent[parent]
    depth = torch.clamp(depth, max=h0 + 8 * chase_passes + 1)
    root_seed = seed.reshape(-1)[parent]
    labels = torch.where(fg.reshape(-1) & root_seed
                         & (depth <= h0 + 8 * chase_passes),
                         parent + 1, 0).view(peak.shape)
    key = torch.where(fg, fgp, float("-inf"))
    nkeys = list(_neighbours(key, float("-inf")))
    nidxs = list(_neighbours(idx, -1))
    for _ in range(flood_iters):
        best_key = torch.full_like(key, float("-inf"))
        best_i = torch.full_like(idx, -1)
        best_lbl = torch.zeros_like(labels)
        for nk, ni, nl in zip(nkeys, nidxs, _neighbours(labels, 0)):
            k = torch.where(nl > 0, nk, float("-inf"))
            better = (nl > 0) & ((k > best_key)
                                 | ((k == best_key) & (ni > best_i)))
            best_key = torch.where(better, k, best_key)
            best_i = torch.where(better, ni, best_i)
            best_lbl = torch.where(better, nl, best_lbl)
        take = fg & (labels == 0) & (best_lbl > 0)
        if not bool(take.any()):
            break
        labels = torch.where(take, best_lbl, labels)
    return labels.to(torch.int32)


def size_filter_and_compact(labels: torch.Tensor,
                            min_size: int) -> torch.Tensor:
    flat = labels.reshape(-1).long()
    counts = torch.bincount(flat, minlength=flat.numel() + 1)
    counts[0] = 0
    keep = (counts > 0) & (counts >= min_size)
    rank = torch.cumsum(keep.long(), 0)
    return torch.where(keep, rank, 0)[flat].view(labels.shape).to(
        torch.int32)
