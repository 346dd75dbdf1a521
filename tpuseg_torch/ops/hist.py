"""The histograms of one-volume inference, on the device (H1-H3,
``csrc/hist.cu``).

They have no Pallas counterpart: the JAX package leaves this work to XLA,
and the stock PyTorch ops for it (``torch.bincount``, ``torch.unique``) read
the size of their output on the host before they launch, which stops the
host once per call. Each function has two versions with one contract:

* ``bin_counts`` (H1), ``percentiles`` (H2), ``label_counts`` (H3) — the
  wrappers. A CUDA tensor launches the hand-written kernel or raises; a CPU
  tensor takes the plain twin. ``.launches`` counts kernel launches.
* ``*_plain`` — the twins, plain PyTorch (and numpy for the CDF), on any
  device.

``percentiles`` is bit-equal to numpy's float32 ``cumsum`` and
``searchsorted(side="left")``, and so to the JAX package's
``tpuseg/data/normalize.histogram_percentile_scalars``: the float32 CDF is
summed in bin order by one thread (a parallel scan rounds in another order,
and a bin's count passes 2**24 at 96x512x512).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuseg_torch.ops import _build

#: the bin rules of :func:`bin_counts`: percentile normalization bins
#: ``(x - lo) / span * bins``, threshold calibration bins ``x * bins``
RULES = ("normalize", "calibrate")


def _index(sample, lo, span, bins: int, rule: str) -> torch.Tensor:
    if rule == "normalize":
        t = (sample - lo[:, None]) / span[:, None] * bins
    else:
        t = sample * bins
    return torch.clamp(t.to(torch.int64), 0, bins - 1)


def bin_counts_plain(sample, lo=None, span=None, bins: int = 4096,
                     rule: str = "normalize") -> torch.Tensor:
    """Twin of :func:`bin_counts`."""
    b = sample.shape[0]
    idx = _index(sample.float(), lo, span, bins, rule)
    idx = idx + torch.arange(b, device=sample.device)[:, None] * bins
    return torch.bincount(idx.reshape(-1), minlength=b * bins).reshape(b, bins)


def bin_counts(sample: torch.Tensor, lo=None, span=None, bins: int = 4096,
               rule: str = "normalize") -> torch.Tensor:
    """(B, bins) int64 histogram of each row of the (B, n) float32
    ``sample``: under ``rule="normalize"`` between the row's ``lo`` and
    ``lo + span`` ((B,) float32 tensors), under ``"calibrate"`` of [0, 1]
    (``lo`` and ``span`` unused). The float32 bin index is truncated toward
    zero and clamped to [0, bins - 1]."""
    if rule not in RULES:
        raise ValueError(f"unknown bin rule {rule!r}")
    if sample.device.type == "cpu":
        return bin_counts_plain(sample, lo, span, bins, rule)
    x = sample.to(torch.float32).contiguous()
    if x.dim() != 2 or not x.is_cuda:
        raise ValueError(f"bin_counts needs a CUDA (B, n) sample, got "
                         f"{x.device} {tuple(x.shape)}")
    b, n = x.shape
    if rule == "normalize":
        lo = lo.to(device=x.device, dtype=torch.float32).contiguous()
        span = span.to(device=x.device, dtype=torch.float32).contiguous()
        if lo.shape != (b,) or span.shape != (b,):
            raise ValueError("bin_counts: lo and span must be (B,) tensors")
    counts = torch.zeros((b, bins), dtype=torch.int64, device=x.device)
    err = _build.load().tpuseg_bin_counts(
        x.data_ptr(), n, b, lo.data_ptr() if rule == "normalize" else None,
        span.data_ptr() if rule == "normalize" else None, bins,
        RULES.index(rule), counts.data_ptr(), _build.stream_ptr())
    _build.check(err, "bin_counts")
    bin_counts.launches += 1
    return counts


bin_counts.launches = 0


def _targets(pcts) -> np.ndarray:
    return np.asarray([np.float32(p / 100.0) for p in pcts], np.float32)


def percentiles_plain(hist, n: int, lo, span, pcts,
                      bins: int = 4096) -> torch.Tensor:
    """Twin of :func:`percentiles`: the float32 CDF summed sequentially by
    numpy, on the host."""
    b = hist.shape[0]
    cdf = np.cumsum(np.asarray(hist.cpu()).astype(np.float32)
                    / np.float32(n), axis=1, dtype=np.float32)
    lo_h = lo.cpu().numpy().astype(np.float32)
    span_h = span.cpu().numpy().astype(np.float32)
    out = np.empty((len(pcts), b), np.float32)
    for i in range(b):
        for j, t in enumerate(_targets(pcts)):
            k = np.searchsorted(cdf[i], t, side="left")
            out[j, i] = lo_h[i] + (np.float32(k) + np.float32(0.5)) \
                / np.float32(bins) * span_h[i]
    return torch.from_numpy(out).to(hist.device)


def percentiles(hist: torch.Tensor, n: int, lo, span, pcts,
                bins: int = 4096) -> torch.Tensor:
    """(len(pcts), B) float32 percentile values, on ``hist``'s device, from
    the (B, bins) counts of ``n`` samples a row between each row's ``lo``
    and ``lo + span``: ``lo + (k + 0.5) / bins * span`` with ``k`` the first
    bin whose float32 CDF reaches ``float32(p / 100)`` (``bins`` if none
    does, as ``searchsorted`` gives)."""
    if hist.device.type == "cpu":
        return percentiles_plain(hist, n, lo, span, pcts, bins)
    counts = hist.to(torch.int64).contiguous()
    b = counts.shape[0]
    if counts.shape != (b, bins) or not 1 <= len(pcts) <= 8:
        raise ValueError(f"percentiles needs (B, {bins}) counts and 1..8 "
                         f"targets, got {tuple(counts.shape)}, {len(pcts)}")
    lo = lo.to(device=counts.device, dtype=torch.float32).contiguous()
    span = span.to(device=counts.device, dtype=torch.float32).contiguous()
    out = torch.empty((len(pcts), b), dtype=torch.float32,
                      device=counts.device)
    targets = (ctypes.c_float * len(pcts))(*_targets(pcts).tolist())
    err = _build.load().tpuseg_percentiles(
        counts.data_ptr(), b, bins, int(n), lo.data_ptr(), span.data_ptr(),
        ctypes.addressof(targets), len(pcts), out.data_ptr(),
        _build.stream_ptr())
    _build.check(err, "percentiles")
    percentiles.launches += 1
    return out


percentiles.launches = 0


def label_counts_plain(labels: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`label_counts`. It also takes labels above N: its
    table is then as long as the largest label needs."""
    flat = labels.reshape(-1).to(torch.int64)
    counts = torch.bincount(flat, minlength=flat.numel() + 1).to(torch.int32)
    counts[0].fill_(0)
    return counts


def label_counts(labels: torch.Tensor) -> torch.Tensor:
    """(N + 1,) int32 voxel count of each label 1..N of the N int32
    ``labels`` (root linear index + 1, so in 0..N); entry 0 (the
    background) is 0. The kernel leaves labels outside 0..N uncounted; the
    twin, which CPU tensors take, counts labels above N too."""
    if labels.device.type == "cpu":
        return label_counts_plain(labels)
    lab = labels.to(torch.int32).contiguous()
    n = lab.numel()
    if n >= 2 ** 31:
        raise ValueError(f"label_counts: {n} voxels exceed the int32 labels")
    counts = torch.zeros(n + 1, dtype=torch.int32, device=lab.device)
    err = _build.load().tpuseg_label_counts(lab.data_ptr(), n,
                                            counts.data_ptr(),
                                            _build.stream_ptr())
    _build.check(err, "label_counts")
    label_counts.launches += 1
    return counts


label_counts.launches = 0
