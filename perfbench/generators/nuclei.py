"""Isolated nuclei: the generator of a mix whose ``volumes`` group names
none.

The shapes and distributions are those of
``tpuseg_torch/data/synthetic.synthesize_volume``: gaussian-ellipsoid nuclei
(radius drawn uniformly, scaled per axis by the anisotropy), rendered inside
a 2.5-radius box, their per-voxel maximum plus additive gaussian noise,
clipped to [0, 1]; centres drawn uniformly with a minimum distance. The
centres and radii are drawn on the host with numpy (rejection sampling, as
the original does); the image is ``gen.render``'s, on the device. The weak
annotations are the centres and the box half-sizes (the radii).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import gen


def draw_nuclei(shape, num: int, radius_range, anisotropy,
                min_center_dist: float, rng: np.random.Generator):
    """(centers, radii), (num, 3) float32: ``synthesize_volume``'s draw.
    Raises if the shape cannot hold ``num`` nuclei at that distance, so
    every seed gets the same number."""
    d, h, w = shape
    an = np.asarray(anisotropy, np.float64)
    centers = np.empty((num, 3))
    radii = np.empty((num, 3))
    n = tries = 0
    while n < num and tries < num * 50:
        tries += 1
        rr = rng.uniform(*radius_range) * an
        c = np.array([rng.uniform(rr[0], d - rr[0]),
                      rng.uniform(rr[1], h - rr[1]),
                      rng.uniform(rr[2], w - rr[2])])
        if n and np.min(np.linalg.norm(centers[:n] - c, axis=1)) \
                < min_center_dist:
            continue
        centers[n], radii[n] = c, rr
        n += 1
    if n < num:
        raise ValueError(f"{shape} holds only {n} of {num} nuclei at "
                         f"distance {min_center_dist}")
    return centers.astype(np.float32), radii.astype(np.float32)


def make_volumes(p: dict, seed: int, device) -> list:
    """The ``count`` volumes of a traffic file's ``volumes`` group
    (``shape``, ``count``, ``nuclei``, ``radius_range``, ``anisotropy``,
    ``noise``, ``min_center_dist``) made from ``seed``, images on
    ``device``."""
    out = []
    for i in range(p["count"]):
        rng = np.random.default_rng(gen.sub_seed(seed, 1, i))
        centers, radii = draw_nuclei(p["shape"], p["nuclei"],
                                     p["radius_range"], p["anisotropy"],
                                     p["min_center_dist"], rng)
        g = torch.Generator(device=device)
        g.manual_seed(gen.sub_seed(seed, 2, i))
        max_radii = [p["radius_range"][1] * a for a in p["anisotropy"]]
        image = gen.render(tuple(p["shape"]), centers, radii, max_radii,
                           p["noise"], g)
        out.append(gen.Volume(image, centers, radii))
    return out
