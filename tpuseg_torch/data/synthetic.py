"""Synthetic microscopy volumes (numpy; a copy of
``tpuseg/data/synthetic.py``, bit-identical for a given seed — the machine
with the card has no JAX, and ``tpuseg.data`` imports it).

Stacks of gaussian-ellipsoid "nuclei" with ground-truth instance labels plus
the weak annotations (box half-sizes and centres): isolated nuclei
(:func:`synthesize_volume`) and the adversarial fixture of touching and
overlapping pairs under noise and an illumination gradient
(:func:`synthesize_touching_volume`).
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

    image, labels = _render(shape, centers, radii, noise, rng)
    return SyntheticVolume(
        image=image,
        labels=labels,
        centers=centers,
        half_sizes=radii.astype(np.float32),
    )


def _render(shape, centers, radii, noise, rng, gradient=0.0):
    """(image, labels) of ellipsoid blobs, each rendered only inside its
    ~3-sigma bounding box (O(sum of blob volumes)); a voxel inside two
    blobs takes the stronger one's label; ``gradient`` dims x linearly,
    then additive gaussian noise and a clip to [0, 1]."""
    D, H, W = shape
    image = np.zeros(shape, np.float32)
    labels = np.zeros(shape, np.int32)
    best = np.zeros(shape, np.float32)
    for k, (c, r) in enumerate(zip(centers, radii)):
        lo = np.maximum(np.floor(c - 2.5 * r).astype(int), 0)
        hi = np.minimum(np.ceil(c + 2.5 * r).astype(int) + 1, [D, H, W])
        if np.any(hi <= lo):
            continue
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        zz, yy, xx = np.meshgrid(
            np.arange(lo[0], hi[0], dtype=np.float32),
            np.arange(lo[1], hi[1], dtype=np.float32),
            np.arange(lo[2], hi[2], dtype=np.float32),
            indexing="ij",
        )
        d2 = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
              + ((xx - c[2]) / r[2]) ** 2)
        blob = np.exp(-0.5 * d2 * 4.0).astype(np.float32)
        image[sl] = np.maximum(image[sl], blob)
        inside = d2 <= 1.0
        take = inside & (blob > best[sl])
        labels[sl][take] = k + 1
        best[sl] = np.maximum(best[sl], np.where(inside, blob, 0.0))
    if gradient > 0.0:
        # linear illumination falloff across x (uneven lighting): stresses
        # fixed-threshold post-proc and global percentile normalization
        ramp = (1.0 - gradient * np.arange(W, dtype=np.float32) / max(W - 1, 1))
        image *= ramp[None, None, :]
    image = image + rng.normal(0.0, noise, shape).astype(np.float32)
    return np.clip(image, 0.0, 1.0), labels


def synthesize_touching_volume(
    shape=(64, 128, 128),
    num_pairs: int = 12,
    num_singles: int = 6,
    radius_range=(4.0, 7.0),
    anisotropy=(0.6, 1.0, 1.0),
    touch_factor: float = 0.9,
    noise: float = 0.05,
    gradient: float = 0.0,
    seed: int = 0,
) -> SyntheticVolume:
    """Adversarial fixture (VERDICT r2 #3): pairs of nuclei whose surfaces
    TOUCH or overlap — the separation case the reference method exists for
    (its peak/watershed post-proc splits touching instances that a plain
    foreground threshold would fuse).

    ``touch_factor`` scales the center distance relative to the sum of the
    two ellipsoids' effective radii along the pair axis: 1.0 = surfaces
    exactly touch, <1 = overlapping (0.8 is heavy), >1 = small gap. The
    intensity image takes the per-voxel max of the two gaussians, producing
    a saddle between the centers; GT labels split at the stronger-blob
    boundary (the geodesic watershed plane). ``gradient`` adds a linear
    x-illumination falloff; ``noise`` sets the additive-gaussian SNR.
    """
    rng = np.random.default_rng(seed)
    D, H, W = shape
    an = np.asarray(anisotropy, np.float32)
    centers, radii = [], []

    def eff_radius(r, u):
        # radius of ellipsoid (semi-axes r) along unit direction u
        return 1.0 / np.sqrt(np.sum((u / r) ** 2))

    def fits(c, r):
        return np.all(c - r >= 0) and np.all(c + r <= np.array([D, H, W]))

    def far_from_others(c):
        if not centers:
            return True
        return np.min(np.linalg.norm(np.array(centers) - c, axis=1)) \
            >= 2.5 * max(radius_range)

    tries = 0
    while len(centers) < 2 * num_pairs and tries < num_pairs * 200:
        tries += 1
        r1 = rng.uniform(*radius_range) * an
        r2 = rng.uniform(*radius_range) * an
        c1 = np.array([rng.uniform(r1[0], D - r1[0]),
                       rng.uniform(r1[1], H - r1[1]),
                       rng.uniform(r1[2], W - r1[2])])
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        dist = touch_factor * (eff_radius(r1, u) + eff_radius(r2, u))
        c2 = c1 + u * dist
        if not (fits(c1, r1) and fits(c2, r2)):
            continue
        if not (far_from_others(c1) and far_from_others(c2)):
            continue
        centers += [c1, c2]
        radii += [r1, r2]

    tries = 0
    while len(centers) < 2 * num_pairs + num_singles and tries < num_singles * 200:
        tries += 1
        r = rng.uniform(*radius_range) * an
        c = np.array([rng.uniform(r[0], D - r[0]),
                      rng.uniform(r[1], H - r[1]),
                      rng.uniform(r[2], W - r[2])])
        if not far_from_others(c):
            continue
        centers.append(c)
        radii.append(r)

    centers = np.array(centers, np.float32).reshape(-1, 3)
    radii = np.array(radii, np.float32).reshape(-1, 3)
    image, labels = _render(shape, centers, radii, noise, rng,
                            gradient=gradient)
    return SyntheticVolume(image=image, labels=labels, centers=centers,
                           half_sizes=radii.astype(np.float32))
