"""Synthetic microscopy volumes (numpy; copy of
``tpuseg/data/synthetic.synthesize_volume``, bit-identical for a given
seed — the machine with the card has no JAX, and ``tpuseg.data`` imports it).

Stacks of gaussian-ellipsoid "nuclei" with ground-truth instance labels plus
the weak annotations (box half-sizes and centres).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticVolume:
    image: np.ndarray      # (D, H, W) float32 in [0, 1] with noise
    labels: np.ndarray     # (D, H, W) int32 GT instance labels 1..K
    centers: np.ndarray    # (K, 3) float32 instance centers (z, y, x)
    half_sizes: np.ndarray # (K, 3) float32 box half-sizes per axis


def synthesize_volume(
    shape=(64, 128, 128),
    num_instances: int = 20,
    radius_range=(4.0, 9.0),
    anisotropy=(0.6, 1.0, 1.0),   # z is usually compressed in microscopy
    noise: float = 0.05,
    min_center_dist: float = 10.0,
    seed: int = 0,
) -> SyntheticVolume:
    rng = np.random.default_rng(seed)
    D, H, W = shape
    centers, radii = [], []
    tries = 0
    while len(centers) < num_instances and tries < num_instances * 50:
        tries += 1
        r = rng.uniform(*radius_range)
        rz, ry, rx = r * anisotropy[0], r * anisotropy[1], r * anisotropy[2]
        c = np.array([
            rng.uniform(rz, D - rz),
            rng.uniform(ry, H - ry),
            rng.uniform(rx, W - rx),
        ])
        if centers and np.min(np.linalg.norm(np.array(centers) - c, axis=1)) < min_center_dist:
            continue
        centers.append(c)
        radii.append(np.array([rz, ry, rx]))
    centers = np.array(centers, np.float32).reshape(-1, 3)
    radii = np.array(radii, np.float32).reshape(-1, 3)

    image = np.zeros(shape, np.float32)
    labels = np.zeros(shape, np.int32)
    best = np.zeros(shape, np.float32)
    # render each blob only inside its 3-sigma-ish bounding box
    for k, (c, r) in enumerate(zip(centers, radii)):
        lo = np.maximum(np.floor(c - 2.5 * r).astype(int), 0)
        hi = np.minimum(np.ceil(c + 2.5 * r).astype(int) + 1, [D, H, W])
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        zz, yy, xx = np.meshgrid(
            np.arange(lo[0], hi[0], dtype=np.float32),
            np.arange(lo[1], hi[1], dtype=np.float32),
            np.arange(lo[2], hi[2], dtype=np.float32),
            indexing="ij",
        )
        d2 = (
            ((zz - c[0]) / r[0]) ** 2
            + ((yy - c[1]) / r[1]) ** 2
            + ((xx - c[2]) / r[2]) ** 2
        )
        blob = np.exp(-0.5 * d2 * 4.0).astype(np.float32)  # ~hard edge at the nominal radius
        image[sl] = np.maximum(image[sl], blob)
        inside = d2 <= 1.0
        take = inside & (blob > best[sl])
        labels[sl][take] = k + 1  # basic slice -> view, assignment sticks
        best[sl] = np.maximum(best[sl], np.where(inside, blob, 0.0))

    image = image + rng.normal(0.0, noise, shape).astype(np.float32)
    image = np.clip(image, 0.0, 1.0)
    return SyntheticVolume(
        image=image,
        labels=labels,
        centers=centers,
        half_sizes=radii.astype(np.float32),
    )
