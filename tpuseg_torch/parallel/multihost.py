"""Multi-process runtime (port of ``tpuseg/parallel/multihost.py``) on
``torch.distributed``.

One process per card (or several CPU processes) form one group; a mesh's
shards are laid out contiguously by process (``parallel/mesh.py``), and each
process holds, feeds and computes only its own shards:

* :func:`initialize` starts the group from arguments or the environment the
  JAX package reads — ``TPUSEG_COORDINATOR`` (``host:port`` of rank 0),
  ``TPUSEG_NUM_PROCESSES``, ``TPUSEG_PROCESS_ID`` — plus
  ``TPUSEG_DIST_BACKEND``; nothing given: a single-process run, no group.
  Process r computes on ``cuda:(r % device_count)``.
* :func:`put_global` uploads a process's own slabs of an array every
  process sees whole (an ``np.memmap`` is read slab by slab);
  :func:`put_replicated` broadcasts tensors from rank 0.
* :func:`comm_device` is where a collective's buffers live: the process's
  card under NCCL, the host under gloo, whose support of CUDA tensors
  differs by operation. The collectives (``parallel/collectives.py``) copy
  through it explicitly.

The backend is chosen once and never switched: ``"nccl"`` for a CUDA device
and ``"gloo"`` for the CPU, unless ``backend=`` or ``TPUSEG_DIST_BACKEND``
names another (gloo puts several processes on one card, which NCCL
refuses). An NCCL failure raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> bool:
    """Start the process group of a multi-process run.

    Resolution order: explicit arguments, then ``TPUSEG_COORDINATOR`` /
    ``TPUSEG_NUM_PROCESSES`` / ``TPUSEG_PROCESS_ID`` /
    ``TPUSEG_DIST_BACKEND``; with no coordinator and no process count it is
    a single-process run and nothing starts. A group of one is started too
    when asked for (the collectives then run through the backend, which is
    how one card checks NCCL). ``device`` picks the default backend (NCCL
    for ``cuda``, gloo otherwise); under CUDA process r takes
    ``cuda:(r % device_count)`` as its current card. Returns whether the
    run has more than one process; safe to call again."""
    if dist.is_initialized():
        return is_multiprocess()
    env = os.environ
    coordinator = coordinator or env.get("TPUSEG_COORDINATOR")
    if num_processes is None and "TPUSEG_NUM_PROCESSES" in env:
        num_processes = int(env["TPUSEG_NUM_PROCESSES"])
    if process_id is None and "TPUSEG_PROCESS_ID" in env:
        process_id = int(env["TPUSEG_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs TPUSEG_COORDINATOR (host:port), "
            "TPUSEG_NUM_PROCESSES and TPUSEG_PROCESS_ID; got "
            f"{coordinator!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"0..{num_processes - 1}")
    device = torch.device(device)
    backend = backend or env.get("TPUSEG_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return is_multiprocess()


def shutdown() -> None:
    """End this process's group (NCCL warns at exit when it is left
    open)."""
    if is_distributed():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether a process group exists (a group of one included): the
    collectives then run through it."""
    return dist.is_available() and dist.is_initialized()


def is_multiprocess() -> bool:
    return is_distributed() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def backend() -> Optional[str]:
    return str(dist.get_backend()) if is_distributed() else None


def device_of_process(p: int, device="cuda") -> torch.device:
    """The device process ``p`` computes on: ``cuda:(p % device_count)``
    for a CUDA device, ``device`` itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"device {device}: CUDA is not available")
    return torch.device("cuda", p % count)


def process_device(device="cuda") -> torch.device:
    """This process's device (see :func:`device_of_process`)."""
    return device_of_process(process_index(), device)


def comm_device() -> torch.device:
    """Where the collectives' buffers live: the current card under NCCL,
    the host under any other backend."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def put_global(array, mesh) -> list:
    """This process's shards of ``array`` (every process passes the same
    global view), split over the mesh's axes along its leading dims and
    uploaded to their devices in the array's dtype, in the order of
    ``mesh.local_ranks()``. Each slab is read on its own, so an
    ``np.memmap`` is never read whole."""
    n_axes = len(mesh.axis_names)
    sizes = tuple(mesh.shape.values())
    extents = [array.shape[d] // sizes[d] for d in range(n_axes)]
    out = []
    for r in mesh.local_ranks():
        index = tuple(slice(i * e, (i + 1) * e)
                      for i, e in zip(mesh.coords(r), extents))
        slab = array[index]
        if not isinstance(slab, torch.Tensor):
            slab = torch.from_numpy(np.array(slab))
        out.append(slab.to(mesh.devices[r]))
    return out


def put_replicated(tensors) -> list:
    """Broadcast each tensor from rank 0 in place (through
    :func:`comm_device`); without a group they are returned as they are."""
    tensors = list(tensors)
    if not is_distributed():
        return tensors
    dev = comm_device()
    with torch.no_grad():
        for t in tensors:
            buf = t.detach().to(dev, copy=True)
            dist.broadcast(buf, 0)
            t.copy_(buf)
    return tensors
