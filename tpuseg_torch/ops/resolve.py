"""Watershed label resolution: pointer chase (K2) and seeded flood (K3).

Port of ``tpuseg/ops/pallas_resolve.py``. Each pass function has two
versions with one contract:

* ``chase_pass`` / ``flood_pass`` — the wrappers. A CUDA tensor launches the
  hand-written kernel (``csrc/resolve.cu``) or raises; a CPU tensor takes
  the plain PyTorch twin. ``.launches`` counts the passes launched on the
  card (the device loops below launch passes that may then not run).
* ``chase_pass_plain`` / ``flood_pass_plain`` — the twins, on any device.

A pass returns exactly what ``iters`` lockstep steps return, but the kernels
do not take the steps one by one. The chase's direction codes are fixed
within a pass, so a pass is ``out[x] = in[p^iters(x)]`` with ``p`` the parent
map: one launch in which every voxel walks up to ``iters`` hops and reads the
value where it arrives (``csrc/common.cuh``). The flood is a wavefront and
cannot be walked: its kernel keeps a few z planes of a (y, x) tile in shared
memory and runs several steps on them per trip through device memory
(``csrc/flood.cuh``), so a pass of 8 steps is two launches.

``chase_resolve`` / ``flood_resolve`` are the loops. On the card they run
on the device, as the TPU version's ``lax.while_loop`` does: one call
(``tpuseg_chase_resolve`` / ``tpuseg_flood_resolve``) enqueues every pass
the loop may run, and each pass reads its gate, the previous pass's count
or flag, from device memory (``csrc/resolve.cu``), so the host reads
nothing. ``chase_pass.launches`` / ``flood_pass.launches`` then count the
passes enqueued. On the CPU, and in the ``*_plain`` loops on any device
(``chip_smoke.py`` holds the two against each other on the card), the host
reads the count or the flag after each pass. Every loop keeps its last
call's gates as ``.last_gates``, a 1-D int32 tensor on the device it ran on
(the slots themselves on the card), and :func:`passes_run` reads from them
how many passes ran. All keep the TPU version's loop structure exactly:

* chase: converged when no foreground zero is left, checked once before the
  first pass and after every pass, up to ``max_passes`` passes;
* flood: whole passes while anything changes, then the remainder pass, so a
  capped flood runs exactly ``max_iters`` lockstep steps.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.neighbors import NEIGHBORS_6, linear_index, shift


def passes_run(gates: torch.Tensor) -> int:
    """The passes a resolve loop ran, from its ``.last_gates``: pass k ran
    iff gates 0..k-1 are all nonzero (a host read, for checks and reports)."""
    return int((gates != 0).to(torch.int32).cumprod(0).sum())


def _gates(slots: list, passes: int) -> torch.Tensor:
    """The host loops' gates: what the card's slots would hold."""
    return torch.tensor(slots[:passes], dtype=torch.int32)


# --------------------------------------------------------------------------
# chase: pointer-chain resolution by direction codes
# --------------------------------------------------------------------------


def chase_steps_plain(values: torch.Tensor, dirs: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """``iters`` lockstep steps of ``V[x] <- V[x + offset(dirs[x])]``, zero
    outside the volume."""
    masks = [dirs == c + 1 for c in range(len(NEIGHBORS_6))]
    v = values
    for _ in range(iters):
        out = v
        for c, (axis, off) in enumerate(NEIGHBORS_6):
            out = torch.where(masks[c], shift(v, axis, off, 0), out)
        v = out
    return v


def chase_pass_plain(values, dirs, fg_mask, iters: int = 8):
    """Twin of :func:`chase_pass`: ``(values after iters steps, int32 count
    of foreground voxels still 0)``."""
    v = chase_steps_plain(values, dirs, iters)
    return v, (fg_mask & (v == 0)).sum(dtype=torch.int32)


def chase_pass(values, dirs, fg_mask, iters: int = 8):
    """One pass == ``iters`` pointer-chase steps. values/dirs: (D, H, W)
    int32, fg_mask bool. Returns ``(values, unresolved)``: ``unresolved`` is
    a 0-d int32 tensor counting foreground voxels whose value is still 0."""
    if values.device.type == "cpu":
        return chase_pass_plain(values, dirs, fg_mask, iters)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    v = values.to(torch.int32).contiguous()
    d = dirs.to(torch.int32).contiguous()
    fg = fg_mask.to(torch.bool).contiguous()
    _build.check_volume(v, d, fg)
    out = torch.empty_like(v)
    count = torch.empty((), dtype=torch.int32, device=v.device)
    depth, h, w = v.shape
    err = _build.load().tpuseg_chase_pass(
        v.data_ptr(), d.data_ptr(), fg.data_ptr(), out.data_ptr(),
        count.data_ptr(), iters, depth, h, w, _build.stream_ptr())
    _build.check(err, "chase_pass")
    chase_pass.launches += 1
    return out, count


chase_pass.launches = 0


def _chase_loop(pass_fn, values, dirs, fg_mask, iters_per_pass, max_passes,
                slots=None):
    """The chase loop with a host read after each pass. ``slots`` (a list)
    receives the count of foreground zeros before the first pass and after
    each pass that ran."""
    slots = [] if slots is None else slots
    v = values
    slots.append(int((fg_mask & (v == 0)).sum()))
    while slots[-1] and len(slots) <= max_passes:
        v, n = pass_fn(v, dirs, fg_mask, iters_per_pass)
        slots.append(int(n))             # one host read per pass
    return v


def chase_resolve(values, dirs, fg_mask, iters_per_pass: int = 8,
                  max_passes: int = 128):
    """Iterate :func:`chase_pass` until every foreground voxel is resolved
    (nonzero) or ``max_passes`` passes ran. Payloads are 0 along unresolved
    chains and flip once to the root's signed value, so "no zero left" is the
    sound fixed-point test. On the card all ``max_passes`` passes are
    enqueued and gated on the device (module docstring)."""
    if values.device.type == "cpu":
        v = chase_resolve_plain(values, dirs, fg_mask, iters_per_pass,
                                max_passes)
        chase_resolve.last_gates = chase_resolve_plain.last_gates
        return v
    if iters_per_pass < 1:
        raise ValueError(f"iters must be >= 1, got {iters_per_pass}")
    v = values.to(torch.int32).contiguous()
    d = dirs.to(torch.int32).contiguous()
    fg = fg_mask.to(torch.bool).contiguous()
    _build.check_volume(v, d, fg)
    if max_passes < 1:
        chase_resolve.last_gates = _gates([], 0).to(v.device)
        return v
    # slot k: the unresolved count after pass k; slot 0 the count before
    flags = torch.zeros(max_passes + 1, dtype=torch.int32, device=v.device)
    flags[0].copy_((fg & (v == 0)).sum(dtype=torch.int32))
    b1 = torch.empty_like(v)
    b2 = torch.empty_like(v) if max_passes > 1 else None
    depth, h, w = v.shape
    err = _build.load().tpuseg_chase_resolve(
        v.data_ptr(), d.data_ptr(), fg.data_ptr(), b1.data_ptr(),
        b2.data_ptr() if b2 is not None else None, flags.data_ptr(),
        iters_per_pass, max_passes, depth, h, w, _build.stream_ptr())
    _build.check(err, "chase_resolve")
    chase_pass.launches += max_passes
    chase_resolve.last_gates = flags[:max_passes]
    return b1 if max_passes % 2 else b2


chase_resolve.last_gates = None


def chase_resolve_plain(values, dirs, fg_mask, iters_per_pass: int = 8,
                        max_passes: int = 128):
    """:func:`chase_resolve` on the plain twin, on any device."""
    slots = []
    v = _chase_loop(chase_pass_plain, values, dirs, fg_mask, iters_per_pass,
                    max_passes, slots)
    chase_resolve_plain.last_gates = _gates(slots, max_passes)
    return v


chase_resolve_plain.last_gates = None


# --------------------------------------------------------------------------
# flood: lockstep seeded flood
# --------------------------------------------------------------------------


def flood_pass_plain(potential, labels, iters: int = 8):
    """Twin of :func:`flood_pass`: ``(labels after iters steps, bool 0-d
    tensor: did any label change)``."""
    fg = potential > float("-inf")
    lin = linear_index(labels.shape, labels.device)
    # the shifted keys and indices do not change between steps
    nkeys = [shift(potential, a, o, float("-inf")) for a, o in NEIGHBORS_6]
    nidxs = [shift(lin, a, o, -1) for a, o in NEIGHBORS_6]
    start = labels
    for _ in range(iters):
        best_key = torch.full_like(potential, float("-inf"))
        best_idx = torch.full_like(lin, -1)
        best_lbl = torch.zeros_like(labels)
        for c, (axis, off) in enumerate(NEIGHBORS_6):
            nlbl = shift(labels, axis, off, 0)
            nkey = torch.where(nlbl > 0, nkeys[c], float("-inf"))
            better = (nkey > best_key) | ((nkey == best_key)
                                         & (nidxs[c] > best_idx))
            best_key = torch.where(better, nkey, best_key)
            best_idx = torch.where(better, nidxs[c], best_idx)
            best_lbl = torch.where(better, nlbl, best_lbl)
        can_take = fg & (labels == 0) & (best_lbl > 0)
        labels = torch.where(can_take, best_lbl, labels)
    return labels, (labels != start).any()


def flood_pass(potential, labels, iters: int = 8):
    """One pass == ``iters`` lockstep flood steps. ``potential`` is float32
    and -inf off the foreground; labels int32. Returns ``(labels, changed)``
    with ``changed`` a 0-d tensor, nonzero iff a label changed."""
    if labels.device.type == "cpu":
        return flood_pass_plain(potential, labels, iters)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    pot = potential.to(torch.float32).contiguous()
    lab = labels.to(torch.int32).contiguous()
    _build.check_volume(pot, lab)
    lib = _build.load()
    out = torch.empty_like(lab)
    # a pass of more steps than one launch runs alternates between two volumes
    tmp = (torch.empty_like(lab)
           if iters > lib.tpuseg_flood_steps_per_launch() else None)
    changed = torch.empty((), dtype=torch.int32, device=lab.device)
    depth, h, w = lab.shape
    err = lib.tpuseg_flood_pass(
        pot.data_ptr(), lab.data_ptr(), out.data_ptr(),
        tmp.data_ptr() if tmp is not None else None,
        changed.data_ptr(), iters, depth, h, w, _build.stream_ptr())
    _build.check(err, "flood_pass")
    flood_pass.launches += 1
    return out, changed


flood_pass.launches = 0


def _flood_loop(pass_fn, seed_labels, fg_mask, potential, max_iters,
                iters_per_pass, slots=None):
    """The flood loop with a host read after each pass. ``slots`` (a list)
    receives 1, then each whole pass's changed flag (0 or 1)."""
    slots = [] if slots is None else slots
    pot = torch.where(fg_mask, potential.float(), float("-inf"))
    labels = torch.where(fg_mask, seed_labels, 0).to(torch.int32)
    full, rem = divmod(max_iters, iters_per_pass)
    slots.append(1)
    while slots[-1] and len(slots) <= full:
        labels, ch = pass_fn(pot, labels, iters_per_pass)
        slots.append(int(bool(ch)))      # one host read per pass
    if rem and slots[-1]:
        labels, _ = pass_fn(pot, labels, rem)
    return labels


def flood_resolve(seed_labels, fg_mask, potential, max_iters: int,
                  iters_per_pass: int = 8):
    """Seeded lockstep flood to its (early-exiting) fixed point, capped at
    exactly ``max_iters`` steps — ``watershed.flood_labels`` semantics. On
    the card every pass the loop may run is enqueued and gated on the
    device (module docstring)."""
    if seed_labels.device.type == "cpu":
        labels = flood_resolve_plain(seed_labels, fg_mask, potential,
                                     max_iters, iters_per_pass)
        flood_resolve.last_gates = flood_resolve_plain.last_gates
        return labels
    if iters_per_pass < 1:
        raise ValueError(f"iters must be >= 1, got {iters_per_pass}")
    pot = torch.where(fg_mask, potential.float(), float("-inf")).contiguous()
    b0 = torch.where(fg_mask, seed_labels, 0).to(torch.int32).contiguous()
    _build.check_volume(pot, b0)
    full, rem = divmod(max_iters, iters_per_pass)
    full = max(full, 0)
    passes = _flood_passes(max_iters, iters_per_pass)
    if passes == 0:
        flood_resolve.last_gates = _gates([], 0).to(b0.device)
        return b0
    lib = _build.load()
    b1 = torch.empty_like(b0)
    tmp = (torch.empty_like(b0)
           if max(iters_per_pass if full else 0, rem)
           > lib.tpuseg_flood_steps_per_launch() else None)
    # slot k: did pass k change a label; slot 0 opens the first pass
    flags = torch.zeros(full + 2, dtype=torch.int32, device=b0.device)
    flags[0].fill_(1)
    depth, h, w = b0.shape
    err = lib.tpuseg_flood_resolve(
        pot.data_ptr(), b0.data_ptr(), b1.data_ptr(),
        tmp.data_ptr() if tmp is not None else None, flags.data_ptr(),
        iters_per_pass, full, rem, depth, h, w, _build.stream_ptr())
    _build.check(err, "flood_resolve")
    flood_pass.launches += passes
    flood_resolve.last_gates = flags[:passes]
    return b1 if passes % 2 else b0


flood_resolve.last_gates = None

#: the state these wrappers keep about their last call, as ``(holder,
#: attribute)``: a captured program points it at its own buffers after
#: each replay (``infer/graph.py``)
LAST_CALL_STATE = ((chase_resolve, "last_gates"),
                   (flood_resolve, "last_gates"))


def _flood_passes(max_iters: int, iters_per_pass: int) -> int:
    """The passes a flood of ``max_iters`` steps may run: the whole ones
    and the remainder."""
    full, rem = divmod(max_iters, iters_per_pass)
    return max(full, 0) + (rem > 0)


def flood_resolve_plain(seed_labels, fg_mask, potential, max_iters: int,
                        iters_per_pass: int = 8):
    """:func:`flood_resolve` on the plain twin, on any device."""
    slots = []
    labels = _flood_loop(flood_pass_plain, seed_labels, fg_mask, potential,
                         max_iters, iters_per_pass, slots)
    flood_resolve_plain.last_gates = _gates(slots, _flood_passes(
        max_iters, iters_per_pass))
    return labels


flood_resolve_plain.last_gates = None
