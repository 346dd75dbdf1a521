"""Traffic generation: what every generator shares, and the lookup of a
mix's generator by name.

A mix's ``volumes`` group names its generator (``"generator"``, a module
``generators/<name>.py`` with ``make_volumes(p, seed, device) ->
[Volume]``; ``"nuclei"`` where it names none); :func:`volumes_for` finds
it. This file holds what generators share: :class:`Volume`,
:func:`sub_seed`, :func:`render` (the image on the device in a few large
calls, its noise drawn there from a seeded ``torch.Generator``, so a
201-Mvox stack takes well under a second where the host copy takes ~12 s),
and the train loop's crop sampler, :func:`sample_patches`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from perfbench import cells


@dataclass
class Volume:
    """One stack: ``image`` (D, H, W) float32 (a device tensor, or numpy on
    the host for the train loop's sampler), ``centers`` and ``half_sizes``
    (K, 3) float32 numpy."""

    image: object
    centers: np.ndarray
    half_sizes: np.ndarray


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed of the stream ``key`` under the run's ``seed``."""
    state = np.random.SeedSequence([int(seed), *key]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def render(shape, centers, radii, max_radii, noise: float,
           generator: torch.Generator, chunk: int = 512) -> torch.Tensor:
    """The (D, H, W) float32 image on ``generator``'s device: each nucleus
    ``exp(-2 d2)`` (d2 the squared ellipsoidal distance) inside its box,
    the maximum over nuclei, plus ``noise`` x N(0, 1), clipped to [0, 1].
    Every nucleus is rendered in a window sized for ``max_radii``, so the
    work and the memory do not depend on the draw."""
    dev = generator.device
    d, h, w = shape
    size = torch.tensor(shape, device=dev)
    c = torch.from_numpy(centers).to(dev)
    r = torch.from_numpy(radii).to(dev)
    lo = torch.floor(c - 2.5 * r).long().clamp(min=0)
    hi = torch.minimum(torch.ceil(c + 2.5 * r).long() + 1, size)
    box = [min(s, 2 * math.ceil(2.5 * m) + 2)
           for s, m in zip(shape, max_radii)]
    image = torch.zeros(d * h * w, dtype=torch.float32, device=dev)
    strides = (h * w, w, 1)
    for k0 in range(0, len(centers), chunk):
        k = slice(k0, k0 + chunk)
        d2 = 0
        idx = 0
        inside = True
        for a in range(3):
            view = [-1, 1, 1, 1]
            view[a + 1] = box[a]
            pos = lo[k, a, None] + torch.arange(box[a], device=dev)
            d2 = d2 + (((pos.float() - c[k, a, None]) / r[k, a, None]) ** 2
                       ).view(view)
            idx = idx + (pos * strides[a]).view(view)
            inside = inside & (pos < hi[k, a, None]).view(view)
        val = torch.exp(-0.5 * d2 * 4.0)
        image.scatter_reduce_(0, idx[inside], val[inside], reduce="amax")
    image = image.view(shape)
    image += noise * torch.randn(shape, generator=generator, device=dev)
    return image.clamp_(0.0, 1.0)


def generator(p: dict) -> str:
    """The generator a ``volumes`` group names."""
    return p.get("generator", "nuclei")


def volumes_for(p: dict, seed: int, device) -> list:
    """The volumes of a ``volumes`` group, made by its generator from
    ``seed``, images on ``device``."""
    mod = cells.load_module("generators", generator(p))
    return mod.make_volumes(p, seed, device)


def sample_patches(volumes, patch, batch: int, max_instances: int,
                   rng: np.random.Generator, jitter: float = 8.0) -> dict:
    """One raw batch of instance-centred crops, with the distributions of
    ``tpuseg_torch/data/sampler.PatchSampler``: a volume at random, a
    nucleus at random, its centre jittered by up to ``jitter``, the crop
    clipped to the volume; the annotations inside the crop, padded to
    ``max_instances``. Images are host numpy (for the reference trainer
    that makes the inference cells' weights)."""
    pd, ph, pw = patch
    out = {"image": [], "centers": [], "half_sizes": [], "valid": []}
    for _ in range(batch):
        vol = volumes[rng.integers(len(volumes))]
        dd, hh, ww = vol.image.shape
        c = vol.centers[rng.integers(len(vol.centers))] \
            + rng.uniform(-jitter, jitter, 3)
        o = np.clip(np.round(c - np.array(patch) / 2).astype(int), 0,
                    np.array([dd - pd, hh - ph, ww - pw]))
        out["image"].append(vol.image[o[0]:o[0] + pd, o[1]:o[1] + ph,
                                      o[2]:o[2] + pw])
        rel = vol.centers - o
        keep = np.all((rel >= 0) & (rel < np.array(patch)), axis=1)
        m = min(int(keep.sum()), max_instances)
        cen = np.zeros((max_instances, 3), np.float32)
        half = np.zeros((max_instances, 3), np.float32)
        valid = np.zeros(max_instances, bool)
        cen[:m] = rel[keep][:m]
        half[:m] = vol.half_sizes[keep][:m]
        valid[:m] = True
        out["centers"].append(cen)
        out["half_sizes"].append(half)
        out["valid"].append(valid)
    return {k: np.stack(v) for k, v in out.items()}
