"""Touching pairs of nuclei among single ones: the adversarial traffic of
``tpuseg_torch/data/synthetic.synthesize_touching_volume`` (its definition,
written out here; the benchmark does not import it), made from a seed.

A ``volumes`` group names ``shape``, ``count``, ``pairs``, ``singles``,
``touch_range``, ``radius_range``, ``anisotropy``, ``noise`` (one level
per volume) and ``min_center_dist``. Each volume draws, on the host with
numpy:

* the pairs first: radii ``r1``, ``r2`` (each ``uniform(radius_range)``
  scaled per axis by the anisotropy), a centre ``c1`` inside the volume by
  ``r1``, a random unit axis ``u`` and ``touch`` uniform in
  ``touch_range``; ``c2 = c1 + u * touch * (e(r1, u) + e(r2, u))``, where
  ``e(r, u) = 1 / |u / r|`` is the ellipsoid's radius along ``u``. Both
  centres lie inside the volume by their radii and at least
  ``min_center_dist`` from every centre placed before the pair; a draw that
  misses is drawn again, up to ``200 * pairs`` draws;
* then the singles, as ``generators/nuclei.py``'s ``draw_nuclei`` places
  nuclei: a radius, a centre inside by it, at least ``min_center_dist``
  from every centre placed before, up to ``50 * singles`` draws.

The image is ``gen.render``'s on the device: the per-voxel maximum of every
nucleus's gaussian (so a pair's two gaussians meet at a saddle), plus the
volume's noise, clipped to [0, 1]. The annotations are every nucleus's
centre and half-sizes (its radii), pairs first. A volume whose nuclei
cannot all be placed raises: every seed gets the same number.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import gen


def effective_radius(r: np.ndarray, u: np.ndarray) -> float:
    """The radius along the unit axis ``u`` of the ellipsoid of semi-axes
    ``r``."""
    return float(1.0 / np.sqrt(np.sum((u / r) ** 2)))


def draw(p: dict, rng: np.random.Generator) -> tuple:
    """``(centers, radii, touch)``: (2 pairs + singles, 3) float32, the
    pairs' members at rows ``2k`` and ``2k + 1``; ``touch`` (pairs,)
    float64. Raises ValueError where the shape cannot hold them."""
    size = np.asarray(p["shape"], np.float64)
    an = np.asarray(p["anisotropy"], np.float64)
    total = 2 * p["pairs"] + p["singles"]
    centers = np.empty((total, 3))
    radii = np.empty((total, 3))
    touch = np.empty(p["pairs"])
    n = 0

    def far(c) -> bool:
        return n == 0 or np.min(np.linalg.norm(centers[:n] - c, axis=1)) \
            >= p["min_center_dist"]

    def inside(c, r) -> bool:
        return bool(np.all(c - r >= 0) and np.all(c + r <= size))

    tries = 0
    while n < 2 * p["pairs"] and tries < 200 * p["pairs"]:
        tries += 1
        r1 = rng.uniform(*p["radius_range"]) * an
        r2 = rng.uniform(*p["radius_range"]) * an
        c1 = rng.uniform(r1, size - r1)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        t = rng.uniform(*p["touch_range"])
        c2 = c1 + u * t * (effective_radius(r1, u) + effective_radius(r2, u))
        if not (inside(c2, r2) and far(c1) and far(c2)):
            continue
        centers[n:n + 2], radii[n:n + 2] = (c1, c2), (r1, r2)
        touch[n // 2] = t
        n += 2
    tries = 0
    while 2 * p["pairs"] <= n < total and tries < 50 * p["singles"]:
        tries += 1
        r = rng.uniform(*p["radius_range"]) * an
        c = rng.uniform(r, size - r)
        if not far(c):
            continue
        centers[n], radii[n] = c, r
        n += 1
    if n < total:
        raise ValueError(f"{tuple(p['shape'])} holds only {n} of {total} "
                         f"nuclei ({p['pairs']} pairs, {p['singles']} "
                         f"singles) at distance {p['min_center_dist']}")
    return centers.astype(np.float32), radii.astype(np.float32), touch


def make_volumes(p: dict, seed: int, device) -> list:
    out = []
    max_radii = [p["radius_range"][1] * a for a in p["anisotropy"]]
    for i in range(p["count"]):
        rng = np.random.default_rng(gen.sub_seed(seed, 1, i))
        centers, radii, _ = draw(p, rng)
        g = torch.Generator(device=device)
        g.manual_seed(gen.sub_seed(seed, 2, i))
        out.append(gen.Volume(gen.render(tuple(p["shape"]), centers, radii,
                                         max_radii, p["noise"][i], g),
                              centers, radii))
    return out
