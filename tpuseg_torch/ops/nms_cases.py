"""Inputs that a tiled peak NMS can get wrong and a whole-volume one cannot:
the cases the K1 and K5 kernels are held to against their plain twins on the
card (``chip_smoke.py``) and the twins against the JAX package on the CPU
(``tests/test_torch_nms.py``, ``tests/test_torch_kernels_ref.py``).

Everything is numpy, made from a seed, so both sides see the same maps.
"""

from __future__ import annotations

import numpy as np

#: the threshold every case is run at
THRESHOLD = 0.5
#: per-axis radii (rz, ry, rx) within the tile pass's limit: zeros, the
#: limit itself and mixed triples
TILE_RADII = ((2, 2, 2), (0, 2, 1), (3, 1, 4), (4, 4, 4), (1, 0, 3),
              (0, 0, 0))
#: radii above the limit: the kernels' chain of whole-volume launches
CHAIN_RADII = ((5, 2, 2), (1, 6, 1))
#: shapes below one (32, 32) tile of (y, x) — the z radius of most
#: ``TILE_RADII`` reaches or passes D = 3 — and one more than a multiple of
#: the tile on y and x with z cut into two chunks of 25 and 24 planes
SMALL_SHAPE = (3, 5, 7)
EDGE_SHAPE = (49, 65, 97)


def _blocky(rng, shape, cell: int, levels: int) -> np.ndarray:
    """A random map of ``levels`` values in [0, 1], constant on cubes of
    ``cell`` voxels: plateaus with flat faces."""
    coarse = rng.integers(0, levels, [-(-s // cell) for s in shape])
    fine = coarse
    for axis in range(3):
        fine = np.repeat(fine, cell, axis=axis)
    d, h, w = shape
    return (fine[:d, :h, :w] / (levels - 1)).astype(np.float32)


def adversarial_maps(shape, seed: int = 0):
    """Yields ``(name, peak_prob, fg_prob)``, float32 arrays of ``shape``:

    * ``constant``: one plateau over the whole volume, all foreground:
      exactly one seed, at the largest linear index, for a radius of 1 or
      more on every axis (:func:`expected_constant_seeds`);
    * ``quantized``: uniform noise rounded to 1/8, so that ties and small
      plateaus cross every tile edge; the foreground (cubes of 3 voxels at
      five levels) cuts through them;
    * ``blocks``: cubes of 5 voxels at four levels for both maps: plateaus
      wider than any radius, with the foreground's own cubes cutting them;
    * ``at threshold``: every voxel is ``THRESHOLD`` exactly, the float32
      just below it, or 0.25: ``>=`` against ``>`` decides each seed.
    """
    rng = np.random.default_rng(seed)
    yield ("constant", np.full(shape, 0.75, np.float32),
           np.ones(shape, np.float32))
    yield ("quantized",
           (np.round(rng.random(shape, dtype=np.float32) * 8) / 8)
           .astype(np.float32), _blocky(rng, shape, 3, 5))
    yield "blocks", _blocky(rng, shape, 5, 4), _blocky(rng, shape, 5, 4)
    thr = np.float32(THRESHOLD)
    levels = np.array([thr, np.nextafter(thr, np.float32(0)), 0.25], np.float32)
    yield ("at threshold", levels[rng.integers(0, 3, shape)],
           _blocky(rng, shape, 3, 5))


def expected_constant_seeds(shape, radius) -> np.ndarray:
    """The seed mask of the ``constant`` case: a voxel survives iff no voxel
    of its window has a larger linear index, that is, iff it is the last
    along every axis whose radius is not 0 — the last voxel alone for a
    radius of 1 or more everywhere."""
    seeds = np.ones(shape, bool)
    for axis, r in enumerate(radius):
        if r > 0:
            last = np.arange(shape[axis]) == shape[axis] - 1
            seeds &= last.reshape([-1 if a == axis else 1 for a in range(3)])
    return seeds
