"""6-neighbourhood shift helpers shared by the post-processing ops
(port of ``tpuseg/ops/neighbors.py``).

A "shift by +1 along axis a" returns a volume y with ``y[v] = x[v + e_a]``
(the value of the neighbour one step in +a), edge voxels filled with
``fill``. The CUDA kernels (``tpuseg_torch/csrc``) use the same neighbour
order for their direction codes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

#: (axis, offset) pairs of the 6-connected neighbourhood; direction code c+1
#: points at NEIGHBORS_6[c].
NEIGHBORS_6: Sequence[tuple[int, int]] = (
    (0, 1), (0, -1),
    (1, 1), (1, -1),
    (2, 1), (2, -1),
)


def shift(x: torch.Tensor, axis: int, offset: int, fill) -> torch.Tensor:
    """y[v] = x[v + offset * e_axis]; out-of-range -> fill. |offset| == 1."""
    if offset not in (1, -1):
        raise ValueError(f"only unit offsets supported, got {offset}")
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = 1
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if offset == 1:
        return torch.cat([x.narrow(axis, 1, n - 1), pad], dim=axis)
    return torch.cat([pad, x.narrow(axis, 0, n - 1)], dim=axis)


def linear_index(shape, device=None) -> torch.Tensor:
    """int32 linear index volume (row-major over D, H, W)."""
    return torch.arange(math.prod(shape), dtype=torch.int32,
                        device=device).reshape(tuple(shape))
