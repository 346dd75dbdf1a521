"""Tiled halo-overlap whole-volume inference (port of ``tpuseg/infer/tiles.py``).

A Python loop over the static tile grid: each step slices a (tile + 2*halo)
block from the edge-padded volume, runs the net on ``tile_batch`` blocks,
crops the cores and writes them into accumulators in the compute dtype.
Cores partition the volume, so no blending; with halo >= the net's
receptive-field radius on every split axis the result equals
``crop(net(edge_pad(volume, halo)))``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.utils.profiling import mark


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def halo3(halo) -> Tuple[int, int, int]:
    """Normalize a scalar-or-per-axis halo spec to a (hd, hh, hw) tuple."""
    if isinstance(halo, (tuple, list)):
        hd, hh, hw = (int(h) for h in halo)
        return hd, hh, hw
    return int(halo), int(halo), int(halo)


def rf_radius_bound(levels: int) -> int:
    """Receptive-field radius of the U-Net with ``levels`` encoder widths:
    measured 2 -> 11, 3 -> 27, 4 -> 53; the analytic bound 8*2^(L-1) - 4
    beyond that (see tpuseg.infer.tiles.rf_radius_bound)."""
    measured = {1: 4, 2: 11, 3: 27, 4: 53}
    return measured.get(levels, 8 * 2 ** (levels - 1) - 4)


@torch.no_grad()
def measure_rf_radius(model, probe_size: int = 96, tol: float = 1e-7) -> int:
    """The net's receptive-field radius, measured: the farthest voxel
    (Chebyshev distance) whose fg logit changes when the centre voxel of a
    zero (1, 1, p, p, p) probe is set to 10.0, in eval mode, on the device
    of the model's parameters. Halo >= this radius makes
    :func:`tiled_forward` voxel-exact; measured 2 levels -> 11, 3 -> 27,
    4 -> 53. The probe must be larger than twice the radius to see it."""
    device = next(model.parameters()).device
    c = probe_size // 2
    x0 = torch.zeros((1, 1, probe_size, probe_size, probe_size),
                     device=device)
    x1 = x0.clone()
    x1[0, 0, c, c, c] = 10.0
    was_training = model.training
    model.eval()
    try:
        d = (model(x1)["fg_logits"] - model(x0)["fg_logits"]).abs()[0]
    finally:
        model.train(was_training)
    nz = torch.nonzero(d > tol)
    if nz.numel() == 0:
        return 0
    return int((nz - c).abs().max())


def tile_grid(shape, tile) -> np.ndarray:
    """Static (N, 3) int32 table of core-tile origins covering ``shape``."""
    counts = [_cdiv(s, t) for s, t in zip(shape, tile)]
    origins = [
        (d * tile[0], h * tile[1], w * tile[2])
        for d in range(counts[0])
        for h in range(counts[1])
        for w in range(counts[2])
    ]
    return np.asarray(origins, np.int32)


def tiled_forward(
    model,                         # (B, 1, d, h, w) -> {"fg_logits", "peak_logits"}
    volume: torch.Tensor,          # (D, H, W) float
    tile: Tuple[int, int, int] = (32, 128, 128),
    halo=16,                       # scalar or per-axis (hd, hh, hw)
    tile_batch: int = 1,
    compute_dtype=torch.float32,
    preprocess=None,               # optional elementwise fn applied per block
) -> Dict[str, torch.Tensor]:
    """Whole-volume logits ``{"fg_logits", "peak_logits"}``, each (D, H, W)
    in ``compute_dtype``. ``preprocess`` (e.g. the percentile normalization)
    runs on each float32 block before the cast to ``compute_dtype``, as
    elementwise ops commute with slicing. Its device stages
    (``utils/profiling.mark``) take turns: ``tile_glue`` (the pad and the
    accumulators, then the block stack, ``preprocess`` and the cast of the
    first tile batch), ``net`` (``model``), ``tile_glue`` (the batch's core
    write-back and the next batch's blocks), ... and a last ``tile_glue``,
    the last batch's write-back."""
    mark("tile_glue", volume)
    D, H, W = volume.shape
    td, th, tw = tile
    hd, hh, hw = halo3(halo)
    Dp, Hp, Wp = _cdiv(D, td) * td, _cdiv(H, th) * th, _cdiv(W, tw) * tw
    if preprocess is None:
        volume = volume.to(compute_dtype)
    # halo on the low side, halo + round-up on the high side, edge values
    vol_pad = F.pad(volume[None, None],
                    (hw, hw + Wp - W, hh, hh + Hp - H, hd, hd + Dp - D),
                    mode="replicate")[0, 0]

    origins = tile_grid((Dp, Hp, Wp), tile).tolist()
    if len(origins) % tile_batch:
        # repeat the last origin; duplicate writebacks land on the same core
        origins += origins[-1:] * (tile_batch - len(origins) % tile_batch)
    bd, bh, bw = td + 2 * hd, th + 2 * hh, tw + 2 * hw

    fg_acc = torch.zeros((Dp, Hp, Wp), dtype=compute_dtype, device=volume.device)
    pk_acc = torch.zeros_like(fg_acc)
    for b in range(0, len(origins), tile_batch):
        batch = origins[b:b + tile_batch]
        blocks = torch.stack([vol_pad[z:z + bd, y:y + bh, x:x + bw]
                              for z, y, x in batch])[:, None]
        if preprocess is not None:
            blocks = preprocess(blocks)
        cast = blocks.to(compute_dtype)
        mark("net", volume)
        out = model(cast)
        # the cast's lifetime ends at the call, as when it was an argument:
        # the graph pool's size follows the order of frees
        del cast
        mark("tile_glue", volume)
        for i, (z, y, x) in enumerate(batch):
            core = (slice(z, z + td), slice(y, y + th), slice(x, x + tw))
            fg_acc[core] = out["fg_logits"][i, hd:hd + td, hh:hh + th, hw:hw + tw]
            pk_acc[core] = out["peak_logits"][i, hd:hd + td, hh:hh + th, hw:hw + tw]
    return {"fg_logits": fg_acc[:D, :H, :W], "peak_logits": pk_acc[:D, :H, :W]}
