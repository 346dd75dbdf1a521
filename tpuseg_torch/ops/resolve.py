"""Watershed label resolution: pointer chase (K2) and seeded flood (K3).

Port of ``tpuseg/ops/pallas_resolve.py``. Each pass function has two
versions with one contract:

* ``chase_pass`` / ``flood_pass`` — the wrappers. A CUDA tensor launches the
  hand-written kernel (``csrc/resolve.cu``) or raises; a CPU tensor takes
  the plain PyTorch twin. ``.launches`` counts passes run by a kernel.
* ``chase_pass_plain`` / ``flood_pass_plain`` — the twins, on any device.

A pass returns exactly what ``iters`` lockstep steps return, but the kernels
do not take the steps one by one. The chase's direction codes are fixed
within a pass, so a pass is ``out[x] = in[p^iters(x)]`` with ``p`` the parent
map: one launch in which every voxel walks up to ``iters`` hops and reads the
value where it arrives (``csrc/common.cuh``). The flood is a wavefront and
cannot be walked: its kernel keeps a few z planes of a (y, x) tile in shared
memory and runs several steps on them per trip through device memory
(``csrc/flood.cuh``), so a pass of 8 steps is two launches.

``chase_resolve`` / ``flood_resolve`` loop over the wrappers; the
``*_plain`` loops run the twins (``chip_smoke.py`` holds the two against each
other on the card). Both keep the TPU version's loop structure exactly:

* chase: converged when no foreground zero is left, checked once before the
  first pass and after every pass, up to ``max_passes`` passes;
* flood: whole passes while anything changes, then the remainder pass, so a
  capped flood runs exactly ``max_iters`` lockstep steps.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.neighbors import NEIGHBORS_6, linear_index, shift

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


def _chase_loop(pass_fn, values, dirs, fg_mask, iters_per_pass, max_passes):
    v = values
    unresolved = bool((fg_mask & (v == 0)).any())
    i = 0
    while unresolved and i < max_passes:
        v, n = pass_fn(v, dirs, fg_mask, iters_per_pass)
        unresolved = int(n) > 0          # one host read per pass
        i += 1
    return v


def chase_resolve(values, dirs, fg_mask, iters_per_pass: int = 8,
                  max_passes: int = 128):
    """Iterate :func:`chase_pass` until every foreground voxel is resolved
    (nonzero) or ``max_passes`` passes ran. Payloads are 0 along unresolved
    chains and flip once to the root's signed value, so "no zero left" is the
    sound fixed-point test."""
    return _chase_loop(chase_pass, values, dirs, fg_mask, iters_per_pass,
                       max_passes)


def chase_resolve_plain(values, dirs, fg_mask, iters_per_pass: int = 8,
                        max_passes: int = 128):
    """:func:`chase_resolve` on the plain twin, on any device."""
    return _chase_loop(chase_pass_plain, values, dirs, fg_mask,
                       iters_per_pass, max_passes)


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
                iters_per_pass):
    pot = torch.where(fg_mask, potential.float(), float("-inf"))
    labels = torch.where(fg_mask, seed_labels, 0).to(torch.int32)
    full, rem = divmod(max_iters, iters_per_pass)
    changed = True
    i = 0
    while changed and i < full:
        labels, ch = pass_fn(pot, labels, iters_per_pass)
        changed = bool(ch)               # one host read per pass
        i += 1
    if rem and changed:
        labels, _ = pass_fn(pot, labels, rem)
    return labels


def flood_resolve(seed_labels, fg_mask, potential, max_iters: int,
                  iters_per_pass: int = 8):
    """Seeded lockstep flood to its (early-exiting) fixed point, capped at
    exactly ``max_iters`` steps — ``watershed.flood_labels`` semantics."""
    return _flood_loop(flood_pass, seed_labels, fg_mask, potential,
                       max_iters, iters_per_pass)


def flood_resolve_plain(seed_labels, fg_mask, potential, max_iters: int,
                        iters_per_pass: int = 8):
    """:func:`flood_resolve` on the plain twin, on any device."""
    return _flood_loop(flood_pass_plain, seed_labels, fg_mask, potential,
                       max_iters, iters_per_pass)
