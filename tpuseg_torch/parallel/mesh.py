"""Shard meshes (the counterpart of ``make_z_mesh`` / ``make_zy_mesh`` in
``tpuseg/infer/sharded.py``).

A :class:`Mesh` names one or two spatial axes, ``("z",)`` or ``("z", "y")``,
mapped to the volume's dims 0 and 1, and holds one ``torch.device`` per
shard in row-major order (shard rank ``iz * n_y + iy``). A device may
repeat: on one card every shard sits on ``cuda:0``, as the JAX package's
tests put eight virtual devices on one CPU. A process runs its shards one
after another; the collectives of ``parallel/collectives.py`` move tensors
between their devices.

Under a multi-process runtime (``parallel/multihost.py``) the shards are
laid out contiguously by process, as JAX orders a global mesh's devices:
shard i of n belongs to process ``i // (n / N)``, and each process holds
only its ``local_ranks()``. With one process every shard is local.

The JAX package's multislice helpers are not ported: they lay a mesh over
TPU slices joined by DCN.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch

from tpuseg_torch.parallel.multihost import (device_of_process,
                                             is_distributed, process_count,
                                             process_index)


class Mesh:
    """``axis_names``, ``shape`` (an ordered ``{axis: size}``, indexed by
    axis name as in JAX), ``devices`` (one ``torch.device`` per shard,
    row-major) and ``processes`` (the process that owns each shard, in the
    runtime's contiguous layout)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 shape: Tuple[int, ...] | None = None):
        devices = tuple(as_device(d) for d in devices)
        shape = (len(devices),) if shape is None else tuple(shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axis_names}")
        if int(np.prod(shape)) != len(devices):
            raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                             f"devices, got {len(devices)}")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, shape))
        self.devices = devices
        self.processes = tuple(shard_processes(len(devices)))

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_ranks(self) -> list:
        """The shards this process holds, ascending."""
        me = process_index()
        return [r for r, p in enumerate(self.processes) if p == me]

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Per-axis index of shard ``rank``."""
        return tuple(int(i) for i in np.unravel_index(
            rank, tuple(self.shape.values())))

    def lines(self, axis: str):
        """The ranks of each line of shards along ``axis`` (the other axis
        fixed), each in ascending index along ``axis``: the groups a
        collective over ``axis`` runs within."""
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        a = self.axis_names.index(axis)
        return [list(line) for line in
                np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a]).tolist()]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"[{', '.join(str(d) for d in self.devices)}])")


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index: a bare ``"cuda"`` is the
    current card, so that it compares equal to a tensor's device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def shard_processes(n: int) -> list:
    """The owner of each of ``n`` shards: ``i // (n / N)`` over the
    runtime's N processes (all 0 without a process group)."""
    if not is_distributed():
        return [0] * n
    count = process_count()
    if n % count:
        raise ValueError(f"{n} shards do not split over {count} processes")
    return [i // (n // count) for i in range(n)]


def place_shards(n: int, device="cuda") -> list:
    """Devices for ``n`` shards: shard ``i`` on visible card ``i`` mod the
    card count for a CUDA device (all on ``cuda:0`` with one card), all on
    ``device`` otherwise. Under a process group a shard sits on its
    process's device (``multihost.device_of_process``)."""
    device = torch.device(device)
    if is_distributed():
        return [device_of_process(p, device) for p in shard_processes(n)]
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"--device {device}: CUDA is not available")
    return [torch.device("cuda", i % count) for i in range(n)]


def make_z_mesh(axis: str = "z", devices=None) -> Mesh:
    """1-D mesh of z slabs, one per device (default: every visible card, or
    one per process under a process group)."""
    if devices is None:
        devices = place_shards(process_count() if is_distributed()
                               else torch.cuda.device_count())
    return Mesh(devices, (axis,))


def make_zy_mesh(shape: Tuple[int, int], axes=("z", "y"),
                 devices=None) -> Mesh:
    """2-D (z, y) mesh of ``shape`` over the volume's dims (0, 1); default
    devices: shard ``i`` on card ``i`` mod the card count."""
    devices = place_shards(int(np.prod(shape))) if devices is None \
        else devices
    return Mesh(devices, tuple(axes), shape)


def replicas(model, devices) -> dict:
    """``{device: model}`` with ``model`` on each distinct device: the
    model itself where its parameters and buffers already are (or where it
    has none), a deep copy moved there elsewhere."""
    tensors = list(model.parameters()) + list(model.buffers())
    out = {}
    for d in dict.fromkeys(as_device(d) for d in devices):
        here = all(t.device == d for t in tensors)
        out[d] = model if here else copy.deepcopy(model).to(d)
    return out
