"""Halo exchange between neighbouring shards (port of
``tpuseg/parallel/halo.py``).

Each shard owns a slab of the volume; the net's receptive field and the
watershed's basins need ``halo`` planes of context from each neighbour
along a sharded dimension. The planes move between the shards' devices
(``parallel/collectives.ppermute``); the outermost shards replicate their
own edge plane, the edge padding of ``infer/tiles.py``.
"""

from __future__ import annotations

import torch

from tpuseg_torch.parallel.collectives import ppermute


def exchange_halo(slabs, halo: int, dim: int = 0) -> list:
    """Extend each slab of a line of shards by ``halo`` planes of its
    neighbours' context along spatial dimension ``dim``.

    ``slabs`` are the line's per-shard slabs in ascending order along the
    mesh axis. Shard i gets the last ``halo`` planes of shard i-1 before and
    the first ``halo`` planes of shard i+1 after; the edge shards replicate
    their own boundary plane (``F.pad(mode="replicate")``). A 2-D (z, y)
    mesh composes two calls (``exchange_mesh_halo``): the second carries
    the first's halo planes along, so the diagonal corners arrive through
    the neighbours."""
    for slab in slabs:
        if halo > slab.shape[dim]:
            raise ValueError(
                f"halo ({halo}) exceeds the local slab extent "
                f"({slab.shape[dim]}) on dim {dim}; a single ppermute only "
                "reaches the immediate neighbor — use a bigger slab or fewer "
                "shards on this axis")
    n = len(slabs)
    size = slabs[0].shape[dim]
    lo_send = [s.narrow(dim, 0, halo) for s in slabs]            # -> i - 1
    hi_send = [s.narrow(dim, size - halo, halo) for s in slabs]  # -> i + 1
    from_before = ppermute(hi_send, [(i, i + 1) for i in range(n - 1)])
    from_after = ppermute(lo_send, [(i + 1, i) for i in range(n - 1)])
    # edge shards: their own boundary plane, replicated
    from_before[0] = slabs[0].narrow(dim, 0, 1).expand_as(lo_send[0])
    from_after[-1] = slabs[-1].narrow(dim, size - 1, 1).expand_as(hi_send[-1])
    return [torch.cat([b, s, a], dim)
            for b, s, a in zip(from_before, slabs, from_after)]


def exchange_z_halo(slabs, halo: int) -> list:
    """(Dl, H, W) slabs of a z line -> (Dl + 2 * halo, H, W)."""
    return exchange_halo(slabs, halo, dim=0)


def exchange_mesh_halo(slabs, halo: int, mesh) -> list:
    """Every shard of ``mesh`` (a list in rank order) extended by ``halo``
    planes along each sharded dim: y first, then z, so that the corners
    fill through the neighbours."""
    out = list(slabs)
    for dim in reversed(range(len(mesh.axis_names))):
        for line in mesh.lines(mesh.axis_names[dim]):
            for r, ext in zip(line, exchange_halo([out[r] for r in line],
                                                  halo, dim)):
                out[r] = ext
    return out
