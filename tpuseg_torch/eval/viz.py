"""Visualization / export of instance segmentations (a numpy copy of
``tpuseg/eval/viz.py``; the machine with the card has no JAX).

Host-side: colorized label volumes (golden-angle hue per instance id, stable
across frames), image/label overlays, and max-intensity-projection previews —
saved as PNG (per-slice or projection) or multi-page TIFF via PIL, which is
imported where a file is written.
"""

from __future__ import annotations

import colorsys
from typing import Optional

import numpy as np


def label_colors(n: int, seed: int = 0) -> np.ndarray:
    """(n+1, 3) uint8 palette; index 0 is black (background). Golden-angle
    hues give adjacent ids distinct colors."""
    out = np.zeros((n + 1, 3), np.uint8)
    for i in range(1, n + 1):
        h = (i * 0.61803398875 + seed * 0.1) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.65 + 0.35 * ((i * 7) % 2), 1.0)
        out[i] = (int(r * 255), int(g * 255), int(b * 255))
    return out


def colorize_labels(labels: np.ndarray) -> np.ndarray:
    """(D, H, W) int labels -> (D, H, W, 3) uint8 RGB."""
    labels = np.asarray(labels)
    n = int(labels.max())
    return label_colors(n)[labels]


def overlay(image: np.ndarray, labels: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """Blend a grayscale volume with colorized labels -> (D, H, W, 3) uint8."""
    img = np.asarray(image, np.float32)
    lo, hi = np.percentile(img, [1.0, 99.8])
    img = np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)
    rgb = colorize_labels(labels).astype(np.float32)
    base = (img[..., None] * 255.0).repeat(3, axis=-1)
    mask = (np.asarray(labels) > 0)[..., None]
    out = np.where(mask, (1 - alpha) * base + alpha * rgb, base)
    return out.astype(np.uint8)


def max_projection(volume_rgb: np.ndarray, axis: int = 0) -> np.ndarray:
    """Max-intensity projection of an RGB volume along ``axis``."""
    return np.asarray(volume_rgb).max(axis=axis)


def save_png(path: str, array: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(array)).save(path)


def export_overlay(
    path: str,
    image: np.ndarray,
    labels: np.ndarray,
    projection: Optional[int] = 0,
) -> None:
    """Write an overlay: PNG max-projection if ``projection`` is an axis,
    else a multi-page RGB TIFF of all slices."""
    ov = overlay(image, labels)
    if projection is not None:
        save_png(path, max_projection(ov, axis=projection))
        return
    from PIL import Image

    pages = [Image.fromarray(ov[z]) for z in range(ov.shape[0])]
    pages[0].save(path, save_all=True, append_images=pages[1:])
