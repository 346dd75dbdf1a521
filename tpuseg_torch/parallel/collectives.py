"""The mesh collectives of the sharded paths, single-process.

The JAX package runs ``lax.all_gather``, ``psum``, ``pmin``, ``pmax`` and
``ppermute`` over mesh axes inside a ``shard_map`` body. Here one process
holds every shard, so each collective takes the list of per-shard tensors
(one per shard of a mesh line, or of the whole mesh) and returns the
result: one tensor on the first shard's device, or a list with one tensor
per shard on that shard's device. A multi-process runtime puts
``torch.distributed`` behind these same functions.
"""

from __future__ import annotations

import torch


def all_gather(parts) -> torch.Tensor:
    """The shards' tensors concatenated along dim 0, on the first shard's
    device."""
    return torch.cat([p.to(parts[0].device) for p in parts])


def psum(parts) -> torch.Tensor:
    """Elementwise sum over the shards, on the first shard's device."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p.to(out.device)
    return out


def pmin(parts) -> torch.Tensor:
    return torch.stack([p.to(parts[0].device) for p in parts]).amin(0)


def pmax(parts) -> torch.Tensor:
    return torch.stack([p.to(parts[0].device) for p in parts]).amax(0)


def ppermute(parts, pairs) -> list:
    """``out[dst] = parts[src]`` for each ``(src, dst)`` in ``pairs``, moved
    to shard ``dst``'s device (that of ``parts[dst]``); a shard no pair
    reaches gets zeros, as in ``lax.ppermute``."""
    out = [torch.zeros_like(p) for p in parts]
    for src, dst in pairs:
        out[dst] = parts[src].to(parts[dst].device)
    return out
