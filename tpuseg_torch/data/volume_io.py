"""Volume I/O (port of ``tpuseg/data/volume_io.py``): numpy containers.

``.npy`` and ``.npz`` are ported; HDF5 and TIFF are not yet (ROADMAP.md) and
raise instead of guessing.
"""

from __future__ import annotations

import os

import numpy as np


def _ext(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5", ".tif", ".tiff"):
        raise NotImplementedError(
            f"{ext} volumes are not ported yet (npy/npz only); see ROADMAP.md")
    if ext not in (".npy", ".npz"):
        raise ValueError(f"unsupported volume extension: {ext}")
    return ext


def load_volume(path: str, dataset: str = "volume",
                mmap: bool = False) -> np.ndarray:
    """Read a (D, H, W) volume from npy/npz; ``mmap=True`` maps an ``.npy``
    read-only instead of reading it (streamed inference reads it chunk by
    chunk)."""
    if _ext(path) == ".npy":
        return np.load(path, mmap_mode="r" if mmap else None)
    with np.load(path) as z:
        key = dataset if dataset in z else list(z.keys())[0]
        return z[key]


def save_volume(path: str, vol: np.ndarray, dataset: str = "volume") -> None:
    """Write a (D, H, W) volume to npy/npz."""
    vol = np.asarray(vol)
    if _ext(path) == ".npy":
        np.save(path, vol)
    else:
        np.savez_compressed(path, **{dataset: vol})


def load_annotations(path: str):
    """Weak annotations: npz with ``centers`` (K,3) and ``half_sizes`` (K,3)."""
    with np.load(path) as z:
        return z["centers"].astype(np.float32), z["half_sizes"].astype(np.float32)


def save_annotations(path: str, centers: np.ndarray, half_sizes: np.ndarray) -> None:
    np.savez_compressed(path, centers=centers, half_sizes=half_sizes)
