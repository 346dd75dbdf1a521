"""Data-parallel training over processes (port of ``tpuseg/train/dp.py``).

The JAX package maps the step over a 1-D ``Mesh(("data",))`` with the batch
sharded on axis 0, the state replicated and the gradients ``pmean``-ed
inside. Here each process is one shard of a 1-D data mesh (one device a
process) and the group is the runtime's (``parallel/multihost.py``):

* the model's BatchNorms share their statistics over the group, so they
  are the global batch's (``models/blocks.GroupMean``);
* parameters and running statistics are broadcast from rank 0 once, and
  the step's averaged gradients keep them equal on every rank
  (``train/step.py``);
* every process draws the same global batch (the sampler is a pure
  function of the seed and the step) and uploads only its slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch.core import Config
from tpuseg_torch.models.blocks import BatchNorm
from tpuseg_torch.parallel.mesh import Mesh, place_shards
from tpuseg_torch.parallel.multihost import (is_distributed, process_count,
                                             put_replicated)
from tpuseg_torch.train.step import make_train_step


def make_data_mesh(axis: str = "data", device="cuda") -> Mesh:
    """1-D mesh with one shard a process, on the process's device."""
    return Mesh(place_shards(process_count(), device), (axis,))


def make_dp_train_step(model, cfg: Config, mesh: Mesh):
    """``step(state, batch, seed) -> metrics`` (``make_train_step``'s) with
    ``batch`` this process's slice of the global batch (``shard_batch``)
    and the gradients, metrics and BatchNorm statistics averaged over
    every process of the runtime, one per shard of ``mesh``. Puts the
    model's BatchNorms on that group and broadcasts its parameters and
    buffers from rank 0 first. The step runs eagerly on every call
    (``infer/graph.train_eager_reason``)."""
    if not is_distributed():
        raise ValueError("data parallelism needs a process group: start it "
                         "with parallel.multihost.initialize()")
    if mesh.size != process_count():
        raise ValueError(f"data mesh of {mesh.size} shards for a group of "
                         f"{process_count()} processes")
    group = dist.group.WORLD
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    put_replicated(list(model.parameters()) + list(model.buffers()))
    return make_train_step(model, cfg, axis_name=group,
                           grad_accum=cfg.train.grad_accum)


def local_examples(batch: Dict[str, np.ndarray], mesh: Mesh) -> dict:
    """This process's slice of a global host batch (views): examples
    ``[r * b, (r + 1) * b)`` of shard r, b the global batch over the
    mesh's shards."""
    n, r = mesh.size, mesh.local_ranks()[0]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} examples does not "
                             f"split over {n} processes")
        b = v.shape[0] // n
        out[k] = v[r * b:(r + 1) * b]
    return out


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh) -> dict:
    """This process's slice of a global host batch, on its device (every
    process passes the same batch and uploads only its examples)."""
    dev = mesh.devices[mesh.local_ranks()[0]]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in local_examples(batch, mesh).items()}
