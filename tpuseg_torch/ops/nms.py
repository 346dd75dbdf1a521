"""Fused 3D peak NMS (K5; port of ``tpuseg/ops/pallas_nms.py``).

``fused_peak_nms(peak_prob, threshold, radius)`` is the boolean seed mask of
``ops.peaks.peak_nms`` — local maxima of the float32 peak map at or above
``threshold``, the (2r+1)-window padded with -inf at the volume's edges, and
on an exact plateau only the candidate with the largest linear index — with
the same per-axis ``radius`` (0 on an axis allowed). A CUDA tensor runs the
hand-written kernels of ``csrc/nms.cu`` (any shape: the TPU wrapper's
fallback for shapes its blocks do not divide has no counterpart) or raises;
a CPU tensor takes the plain twin, which is :func:`ops.peaks.peak_nms`.
``PostprocConfig.nms_impl="pallas"`` selects it (``ops/watershed.py``).
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.peaks import peak_nms, radius3

#: the plain PyTorch twin of :func:`fused_peak_nms`, on any device
fused_peak_nms_plain = peak_nms


def fused_peak_nms(peak_prob: torch.Tensor, threshold: float,
                   radius=2) -> torch.Tensor:
    """Boolean (D, H, W) seed mask of ``peak_prob`` (taken as float32)."""
    if peak_prob.device.type == "cpu":
        return fused_peak_nms_plain(peak_prob, threshold, radius)
    rz, ry, rx = radius3(radius)
    if min(rz, ry, rx) < 0:
        raise ValueError(f"NMS radius must be >= 0, got {(rz, ry, rx)}")
    peak = peak_prob.to(torch.float32).contiguous()
    _build.check_volume(peak)
    f0, f1 = torch.empty_like(peak), torch.empty_like(peak)
    cidx, i0, i1 = (torch.empty(peak.shape, dtype=torch.int32,
                                device=peak.device) for _ in range(3))
    seeds = torch.empty(peak.shape, dtype=torch.bool, device=peak.device)
    d, h, w = peak.shape
    err = _build.load().tpuseg_peak_nms(
        peak.data_ptr(), float(threshold), rz, ry, rx, d, h, w,
        f0.data_ptr(), f1.data_ptr(), cidx.data_ptr(), i0.data_ptr(),
        i1.data_ptr(), seeds.data_ptr(), _build.stream_ptr())
    _build.check(err, "fused_peak_nms")
    fused_peak_nms.launches += 1
    return seeds


fused_peak_nms.launches = 0
