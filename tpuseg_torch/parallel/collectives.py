"""The mesh collectives of the sharded paths.

The JAX package runs ``lax.all_gather``, ``psum``, ``pmin``, ``pmax`` and
``ppermute`` over mesh axes inside a ``shard_map`` body. Here a process
holds its own shards, so each collective takes the list of its per-shard
tensors (one per local shard of a mesh line, or of the whole mesh, in
ascending shard order) and returns the result: one tensor on the first
shard's device, or for ``ppermute`` a list with one tensor per shard on
that shard's device.

Without a process group one process holds every shard and the shards'
parts are combined where they lie. Under a group (``parallel/multihost.py``)
the local parts are combined first and one ``torch.distributed`` collective
then runs across the ranks, through ``multihost.comm_device`` (the card
under NCCL, host copies under gloo). Every rank must make the same
collective calls in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuseg_torch.parallel.multihost import (comm_device, is_distributed,
                                             process_count, process_index)


def _all_reduce(t: torch.Tensor, op, group=None) -> torch.Tensor:
    """``t`` reduced over the ranks of ``group`` by ``op``, on ``t``'s
    device (``t`` itself is not changed)."""
    buf = t.to(comm_device(), copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def group_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (``lax.pmean``)."""
    return _all_reduce(t, dist.ReduceOp.SUM, group) / dist.get_world_size(
        group)


def _gather_ragged(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order; the ranks'
    row counts may differ (the sizes go first, then rows padded to the
    largest)."""
    dev = comm_device()
    x = t.to(dev)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(n) for _ in range(process_count())]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    most = max(sizes)
    if most == 0:
        return x.new_empty((0,) + tuple(x.shape[1:]))
    if x.shape[0] < most:
        x = torch.cat([x, x.new_zeros((most - x.shape[0],) + x.shape[1:])])
    bufs = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(bufs, x.contiguous())
    return torch.cat([b[:s] for b, s in zip(bufs, sizes)])


def all_gather(parts, ragged: bool = False) -> torch.Tensor:
    """The shards' tensors concatenated along dim 0 in shard order, on the
    first local shard's device. Under a process group every rank's parts
    must have the same shape, as the fixed-size tables of the sharded paths
    do; ``ragged=True`` lets the ranks' row counts differ, at the price of
    one more collective for the sizes and their read on the host."""
    local = torch.cat([p.to(parts[0].device) for p in parts])
    if not is_distributed():
        return local
    if ragged:
        return _gather_ragged(local).to(parts[0].device)
    x = local.to(comm_device()).contiguous()
    bufs = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(bufs, x)
    return torch.cat(bufs).to(parts[0].device)


def psum(parts) -> torch.Tensor:
    """Elementwise sum over the shards, on the first shard's device."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p.to(out.device)
    if not is_distributed():
        return out
    return _all_reduce(out, dist.ReduceOp.SUM)


def pmin(parts) -> torch.Tensor:
    out = torch.stack([p.to(parts[0].device) for p in parts]).amin(0)
    return _all_reduce(out, dist.ReduceOp.MIN) if is_distributed() else out


def pmax(parts) -> torch.Tensor:
    out = torch.stack([p.to(parts[0].device) for p in parts]).amax(0)
    return _all_reduce(out, dist.ReduceOp.MAX) if is_distributed() else out


def ppermute(parts, pairs, owners=None) -> list:
    """``out[dst] = parts[src]`` for each ``(src, dst)`` in ``pairs``, moved
    to shard ``dst``'s device (that of ``parts[dst]``); a shard no pair
    reaches gets zeros, as in ``lax.ppermute``.

    Under a process group ``owners[i]`` is the process holding shard ``i``
    of the list, ``parts[i]`` is ``None`` where that is another process,
    and so is the result; every shard's tensor has one shape and dtype, so
    a receiver sizes its buffer from its own. A pair between two processes
    is one send and one receive, posted by both in ``pairs``' order and
    tagged by its position."""
    if not is_distributed():
        out = [torch.zeros_like(p) for p in parts]
        for src, dst in pairs:
            out[dst] = parts[src].to(parts[dst].device)
        return out
    me = process_index()
    dev = comm_device()
    out = [None if p is None else torch.zeros_like(p) for p in parts]
    ops, received = [], []
    for tag, (src, dst) in enumerate(pairs):
        mine_src, mine_dst = owners[src] == me, owners[dst] == me
        if mine_src and mine_dst:
            out[dst] = parts[src].to(parts[dst].device)
        elif mine_src and parts[src].numel():
            ops.append(dist.P2POp(dist.isend, parts[src].to(dev).contiguous(),
                                  owners[dst], tag=tag))
        elif mine_dst and parts[dst].numel():
            buf = torch.empty(parts[dst].shape, dtype=parts[dst].dtype,
                              device=dev)
            ops.append(dist.P2POp(dist.irecv, buf, owners[src], tag=tag))
            received.append((dst, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for dst, buf in received:
        out[dst] = buf.to(parts[dst].device)
    return out
