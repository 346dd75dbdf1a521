"""3D max-pool peak NMS — seed detection (port of ``tpuseg/ops/peaks.py``).

Plateau handling: on exact ties inside an NMS window only the candidate with
the largest linear index survives, so the op is deterministic. The index
tie-break pools int32 indices: ``F.max_pool3d`` pools only floats, and above
2**24 voxels (the 96x512x512 stack has 25.2M) float32 cannot hold every
index, so a float pool would merge neighbouring candidates.

Also the rule that picks the body of the two CUDA kernels that compute this
function (K1, ``ops/seed.py``; K5, ``ops/nms.py``): :func:`nms_body`.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops.neighbors import linear_index


#: The tile pass of ``csrc/nms.cuh``: the largest per-axis radius it is
#: compiled for (the z window lives in registers, the (y, x) window's slots
#: per thread are sized for a halo of twice this), its (y, x) tile and the
#: planes it takes a step.
TILE_MAX_RADIUS = 4
TILE_YX = (32, 32)
TILE_PLANES = 4
#: ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of an H100; on a card the
#: wrappers pass the device's own (``_build.smem_optin``)
SMEM_OPTIN_H100 = 232_448


def nms_tile_smem_bytes(radius) -> int:
    """Dynamic shared memory of one block of the tile pass: for each plane of
    a step three float32/int32 planes of the (y, x) window with its halo of
    2r (a seed depends on candidates r away, a candidate on peaks r
    further): this step's raw plane, the next step's on its way, and the
    x-pooled plane. The z radius costs registers, not shared memory."""
    _, ry, rx = radius3(radius)
    return (3 * TILE_PLANES * (TILE_YX[0] + 4 * ry) * (TILE_YX[1] + 4 * rx)
            * 4)


def nms_body(radius, smem_optin: int = SMEM_OPTIN_H100) -> str:
    """Which body of the K1 / K5 kernels takes ``radius``: ``"tile"``, the
    one-launch shared-memory tile pass, for every per-axis radius in
    0..``TILE_MAX_RADIUS`` whose window fits the shared memory a block may
    opt in to; ``"chain"``, the whole-volume launches through five scratch
    volumes, for larger radii. Decided from the arguments alone, before any
    launch."""
    r = radius3(radius)
    if min(r) < 0:
        raise ValueError(f"NMS radius must be >= 0, got {r}")
    if max(r) <= TILE_MAX_RADIUS and nms_tile_smem_bytes(r) <= smem_optin:
        return "tile"
    return "chain"


def radius3(radius) -> tuple:
    """Normalize an NMS radius to a per-axis (rz, ry, rx) tuple."""
    if isinstance(radius, (tuple, list)):
        rz, ry, rx = (int(r) for r in radius)
        return rz, ry, rx
    return (int(radius),) * 3


def maxpool_same(x: torch.Tensor, radius, fill) -> torch.Tensor:
    """(2r+1)-window max over (D, H, W) with SAME padding by ``fill``, as
    separable shifted maxima — exact for every dtype, integers included."""
    for axis, r in enumerate(radius3(radius)):
        if r == 0:
            continue
        n = x.shape[axis]
        pad_shape = list(x.shape)
        pad_shape[axis] = r
        pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
        padded = torch.cat([pad, x, pad], dim=axis)
        acc = padded.narrow(axis, 0, n)
        for off in range(1, 2 * r + 1):
            acc = torch.maximum(acc, padded.narrow(axis, off, n))
        x = acc
    return x


def peak_nms(peak_prob: torch.Tensor, threshold: float, radius=2) -> torch.Tensor:
    """Boolean seed mask: local maxima of ``peak_prob`` (float32) that are at
    least ``threshold``; ``radius`` is an int or per-axis (rz, ry, rx)."""
    peak = peak_prob.float()
    mx = maxpool_same(peak, radius, float("-inf"))
    cand = (peak >= threshold) & (peak >= mx)
    cand_idx = torch.where(cand, linear_index(peak.shape, peak.device), -1)
    mi = maxpool_same(cand_idx, radius, -1)
    return cand & (cand_idx == mi)
