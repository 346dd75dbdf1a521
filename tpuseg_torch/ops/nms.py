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

On the card the body follows ``ops.peaks.nms_body(radius)``, decided before
any launch. ``"tile"`` (every per-axis radius 0..4): one launch of the tile
pass, which allocates the byte mask and nothing else. ``"chain"`` (larger
radii): up to seven whole-volume pooling launches and a compare, through
five scratch volumes. ``fused_peak_nms.launches`` counts calls that launched
either, ``fused_peak_nms.tile_launches`` those of the tile pass.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.peaks import nms_body, peak_nms, radius3

#: the plain PyTorch twin of :func:`fused_peak_nms`, on any device
fused_peak_nms_plain = peak_nms


def fused_peak_nms(peak_prob: torch.Tensor, threshold, radius=2,
                   body: str | None = None) -> torch.Tensor:
    """Boolean (D, H, W) seed mask of ``peak_prob`` (taken as float32).
    ``threshold``: a float or a 0-d tensor; the kernel reads it from device
    memory.

    ``body`` is a hook for the card's checks and timings (see
    ``ops.seed.seed_chase_pass``); it is not reachable from a config."""
    if peak_prob.device.type == "cpu":
        return fused_peak_nms_plain(peak_prob, threshold, radius)
    rz, ry, rx = radius3(radius)
    peak = peak_prob.to(torch.float32).contiguous()
    _build.check_volume(peak)
    rule = nms_body((rz, ry, rx), smem_optin=_build.smem_optin())
    if body not in (None, "chain", rule):
        raise ValueError(f"radius {(rz, ry, rx)} takes the {rule} body, "
                         f"not {body!r}")
    body = body or rule
    seeds = torch.empty(peak.shape, dtype=torch.bool, device=peak.device)
    d, h, w = peak.shape
    lib = _build.load()
    thr = _build.device_scalars(threshold, device=peak.device)
    if body == "tile":
        err = lib.tpuseg_peak_nms(
            peak.data_ptr(), thr.data_ptr(), rz, ry, rx, d, h, w,
            seeds.data_ptr(), _build.stream_ptr())
    else:
        f0, f1 = torch.empty_like(peak), torch.empty_like(peak)
        cidx, i0, i1 = (torch.empty(peak.shape, dtype=torch.int32,
                                    device=peak.device) for _ in range(3))
        err = lib.tpuseg_peak_nms_chain(
            peak.data_ptr(), thr.data_ptr(), rz, ry, rx, d, h, w,
            f0.data_ptr(), f1.data_ptr(), cidx.data_ptr(), i0.data_ptr(),
            i1.data_ptr(), seeds.data_ptr(), _build.stream_ptr())
    _build.check(err, f"fused_peak_nms ({body})")
    fused_peak_nms.launches += 1
    fused_peak_nms.tile_launches += body == "tile"
    return seeds


fused_peak_nms.launches = 0
fused_peak_nms.tile_launches = 0
