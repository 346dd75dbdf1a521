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


def exchange_halo(slabs, halo: int, dim: int = 0, owners=None) -> list:
    """Extend each slab of a line of shards by ``halo`` planes of its
    neighbours' context along spatial dimension ``dim``.

    ``slabs`` are the line's per-shard slabs in ascending order along the
    mesh axis. Shard i gets the last ``halo`` planes of shard i-1 before and
    the first ``halo`` planes of shard i+1 after; the edge shards replicate
    their own boundary plane (``F.pad(mode="replicate")``). A 2-D (z, y)
    mesh composes two calls (``exchange_mesh_halo``): the second carries
    the first's halo planes along, so the diagonal corners arrive through
    the neighbours. Under a process group ``owners`` names each shard's
    process and another process's slab is ``None`` (``ppermute``), in the
    result too."""
    for slab in slabs:
        if slab is not None and halo > slab.shape[dim]:
            raise ValueError(
                f"halo ({halo}) exceeds the local slab extent "
                f"({slab.shape[dim]}) on dim {dim}; a single ppermute only "
                "reaches the immediate neighbor — use a bigger slab or fewer "
                "shards on this axis")
    held = [s for s in slabs if s is not None]
    if not held:
        return list(slabs)
    n = len(slabs)
    size = held[0].shape[dim]
    lo_send = [None if s is None else s.narrow(dim, 0, halo)
               for s in slabs]                                   # -> i - 1
    hi_send = [None if s is None else s.narrow(dim, size - halo, halo)
               for s in slabs]                                   # -> i + 1
    from_before = ppermute(hi_send, [(i, i + 1) for i in range(n - 1)],
                           owners)
    from_after = ppermute(lo_send, [(i + 1, i) for i in range(n - 1)],
                          owners)
    # edge shards: their own boundary plane, replicated
    if slabs[0] is not None:
        from_before[0] = slabs[0].narrow(dim, 0, 1).expand_as(lo_send[0])
    if slabs[-1] is not None:
        from_after[-1] = slabs[-1].narrow(dim, size - 1, 1).expand_as(
            hi_send[-1])
    return [None if s is None else torch.cat([b, s, a], dim)
            for b, s, a in zip(from_before, slabs, from_after)]


def exchange_z_halo(slabs, halo: int) -> list:
    """(Dl, H, W) slabs of a z line -> (Dl + 2 * halo, H, W)."""
    return exchange_halo(slabs, halo, dim=0)


def exchange_mesh_halo(slabs, halo: int, mesh) -> list:
    """Every local shard of ``mesh`` (``slabs`` in the order of
    ``mesh.local_ranks()``) extended by ``halo`` planes along each sharded
    dim: y first, then z, so that the corners fill through the
    neighbours."""
    local = mesh.local_ranks()
    out = [None] * mesh.size
    for r, s in zip(local, slabs):
        out[r] = s
    for dim in reversed(range(len(mesh.axis_names))):
        for line in mesh.lines(mesh.axis_names[dim]):
            ext = exchange_halo([out[r] for r in line], halo, dim,
                                [mesh.processes[r] for r in line])
            for r, e in zip(line, ext):
                out[r] = e
    return [out[r] for r in local]
