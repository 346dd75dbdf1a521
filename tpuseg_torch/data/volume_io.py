"""Volume I/O (port of ``tpuseg/data/volume_io.py``): microscopy stacks and
label volumes, the container chosen by extension:

  .npy / .npz     numpy (always available; ``.npy`` can be memory-mapped)
  .h5 / .hdf5     HDF5 via h5py (dataset name "volume" by default)
  .tif / .tiff    multi-page TIFF via PIL (grayscale 8/16/32-bit pages)

h5py and PIL are imported where a file of theirs is read or written; a
machine without one raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import os

import numpy as np

_PACKAGES = {".h5": "h5py", ".hdf5": "h5py", ".tif": "PIL", ".tiff": "PIL"}


def _ext(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".npy", ".npz", *_PACKAGES):
        raise ValueError(f"unsupported volume extension: {ext}")
    return ext


def _needs(ext: str, path: str):
    """The module that reads and writes ``ext`` (h5py, or PIL's Image)."""
    try:
        if ext in (".h5", ".hdf5"):
            import h5py

            return h5py
        from PIL import Image

        return Image
    except ImportError as e:
        raise ImportError(f"{path}: {ext} volumes need the {_PACKAGES[ext]} "
                          "package, which is not installed") from e


def load_volume(path: str, dataset: str = "volume",
                mmap: bool = False) -> np.ndarray:
    """Read a (D, H, W) volume from npy/npz/h5/tiff; ``mmap=True`` maps an
    ``.npy`` read-only instead of reading it (streamed inference reads it
    chunk by chunk)."""
    ext = _ext(path)
    if ext == ".npy":
        return np.load(path, mmap_mode="r" if mmap else None)
    if ext == ".npz":
        with np.load(path) as z:
            key = dataset if dataset in z else list(z.keys())[0]
            return z[key]
    if ext in (".h5", ".hdf5"):
        with _needs(ext, path).File(path, "r") as f:
            key = dataset if dataset in f else list(f.keys())[0]
            return np.asarray(f[key])
    image = _needs(ext, path)
    from PIL import ImageSequence

    with image.open(path) as im:
        pages = [np.asarray(p) for p in ImageSequence.Iterator(im)]
    return np.stack(pages, axis=0)


def save_volume(path: str, vol: np.ndarray, dataset: str = "volume") -> None:
    """Write a (D, H, W) volume; container chosen by extension."""
    vol = np.asarray(vol)
    ext = _ext(path)
    if ext == ".npy":
        np.save(path, vol)
    elif ext == ".npz":
        np.savez_compressed(path, **{dataset: vol})
    elif ext in (".h5", ".hdf5"):
        with _needs(ext, path).File(path, "w") as f:
            f.create_dataset(dataset, data=vol, compression="gzip")
    else:
        image = _needs(ext, path)
        if vol.dtype in (np.int64, np.uint64):
            vol = vol.astype(np.int32)
        pages = [image.fromarray(vol[z]) for z in range(vol.shape[0])]
        pages[0].save(path, save_all=True, append_images=pages[1:])


def load_annotations(path: str):
    """Weak annotations: npz with ``centers`` (K,3) and ``half_sizes`` (K,3)."""
    with np.load(path) as z:
        return z["centers"].astype(np.float32), z["half_sizes"].astype(np.float32)


def save_annotations(path: str, centers: np.ndarray, half_sizes: np.ndarray) -> None:
    np.savez_compressed(path, centers=centers, half_sizes=half_sizes)
