"""Seeded watershed (port of ``tpuseg/ops/watershed.py``).

Three compositions, as in the TPU package's kernel path
(``resolve_impl="auto"`` on a TPU). A CUDA volume goes through the
hand-written kernels, a CPU volume through their plain twins. Labels are
basin-root linear index + 1.

* ``method="ascent"``, ``nms_impl="xla"`` (the default,
  ``ops/watershed.py:268-286``): fused seeding (K1, ``ops/seed.py``), the
  pointer chase to convergence (K2) and the seeded flood that absorbs
  unseeded basins (K3, ``ops/resolve.py``).
* ``method="ascent"``, ``nms_impl="pallas"`` (``ops/watershed.py:288-299``):
  the seeds come from the peak-NMS kernel (K5, ``ops/nms.py``), the
  direction codes and the root payloads from plain tensor code, and the
  chase (K2) starts at step 0; then the same flood. Elementwise equal to the
  default. In the TPU package the fused seed pass overrides this setting
  wherever its block shape fits; here the setting selects the composition.
* ``method="flood"`` (``ops/watershed.py:316-321``): the seeds (the plain
  ``ops.peaks.peak_nms`` under ``nms_impl="xla"``, K5 under ``"pallas"``)
  flooded over the foreground by K3, with no ascent.

``resolve_impl="xla"`` is the JAX package's XLA composition, its default
off the TPU, as plain tensor code on any device: the seeds from the plain
``peak_nms`` (or K5 under ``nms_impl="pallas"``), steepest-ascent parents
resolved by exactly ``ascent_rounds`` rounds of pointer jumping
(:func:`ascent_labels`, so a chain longer than ``2**ascent_rounds`` stops
short at a non-root, whose basin is then dropped and flooded), and the
plain flood (``ops/resolve.flood_resolve_plain``, ``flood_labels``'s
semantics).

Not ported (``NotImplementedError``): ``label_space="dense"``, a TPU
workaround (see ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from tpuseg_torch.ops.neighbors import NEIGHBORS_6, linear_index, shift


def _steepest(potential, mask):
    """``(idx, best_idx, best_code)``: each voxel's linear index and the
    argmax over {self} U 6 neighbours of (potential, linear index), with
    neighbours outside ``mask`` at -inf, as an index and as a code (0 =
    self, c + 1 = NEIGHBORS_6[c])."""
    potential = torch.where(mask, potential.float(), float("-inf"))
    idx = linear_index(potential.shape, potential.device)
    best_pot, best_idx = potential, idx
    best_code = torch.zeros(potential.shape, dtype=torch.int32,
                            device=potential.device)
    for c, (axis, off) in enumerate(NEIGHBORS_6):
        npot = shift(potential, axis, off, float("-inf"))
        nidx = shift(idx, axis, off, -1)
        better = (npot > best_pot) | ((npot == best_pot) & (nidx > best_idx))
        best_pot = torch.where(better, npot, best_pot)
        best_idx = torch.where(better, nidx, best_idx)
        best_code = torch.where(better, c + 1, best_code)
    return idx, best_idx, best_code


def steepest_dir_codes(potential, mask, self_sticky=None):
    """Direction code per voxel: 0 = self/root, 1..6 = NEIGHBORS_6 order —
    the steepest (potential, linear index) ascent step; ``self_sticky``
    voxels keep 0."""
    _, _, best_code = _steepest(potential, mask)
    code = torch.where(mask, best_code, 0)
    if self_sticky is not None:
        code = torch.where(self_sticky & mask, 0, code)
    return code.to(torch.int32)


def _steepest_parent(potential, mask, self_sticky=None):
    """Parent linear index per voxel: the steepest ascent step's target,
    the voxel itself off ``mask`` and at ``self_sticky`` voxels."""
    idx, best_idx, _ = _steepest(potential, mask)
    parent = torch.where(mask, best_idx, idx)
    if self_sticky is not None:
        parent = torch.where(self_sticky & mask, idx, parent)
    return parent


def _pointer_jump(parent_flat: torch.Tensor, rounds: int) -> torch.Tensor:
    """``rounds`` rounds of ``p = p[p]``: each voxel 2**rounds steps up its
    chain (or at the chain's root)."""
    p = parent_flat.to(torch.int64)
    for _ in range(rounds):
        p = p[p]
    return p.to(parent_flat.dtype)


def ascent_labels(potential, fg_mask, seed_mask=None, rounds=None):
    """Watershed by steepest ascent: int32 labels = the voxel reached by
    ``rounds`` pointer-jump rounds up the ascent chain, as linear index +
    1, on the foreground; 0 off it. ``seed_mask`` voxels are forced roots.
    ``rounds=None`` takes ceil(log2(N)), enough for any chain; fewer rounds
    leave chains longer than ``2**rounds`` at a voxel short of their
    root."""
    parent = _steepest_parent(potential, fg_mask, self_sticky=seed_mask)
    if rounds is None:
        rounds = max(1, math.ceil(math.log2(max(potential.numel(), 2))))
    root = _pointer_jump(parent.reshape(-1), rounds).reshape(parent.shape)
    return torch.where(fg_mask, root + 1, 0).to(torch.int32)


def threshold_mask(prob, threshold) -> torch.Tensor:
    """``prob >= threshold`` as the JAX package compares: a Python float is
    weakly typed there and compares in the map's dtype; a 0-d tensor (a
    traced scalar there, as the calibrated threshold is) compares in the
    promoted dtype, float32 for a bf16 map, as K1 compares its maps. (Torch
    alone would round a 0-d float32 threshold to a bf16 map's dtype.)"""
    if isinstance(threshold, torch.Tensor):
        dtype = torch.promote_types(prob.dtype, threshold.dtype)
        return prob.to(dtype) >= threshold.to(dtype)
    return prob >= threshold


def flood_truncation_count(labels, fg_mask) -> torch.Tensor:
    """int32 count of foreground voxels the flood cap truncated: unlabeled
    fg adjacent to a labeled basin. Zero iff the flood reached its fixed
    point (seedless components are dropped by design, not counted)."""
    lab_pos = labels > 0
    nbr_lab = torch.zeros_like(lab_pos)
    for axis, off in NEIGHBORS_6:
        nbr_lab = nbr_lab | shift(lab_pos, axis, off, False)
    return (fg_mask & ~lab_pos & nbr_lab).sum(dtype=torch.int32)


def watershed(fg_prob, peak_prob, peak_threshold: float = 0.5,
              fg_threshold: float = 0.5, peak_radius=2,
              flood_iters: int = 96, method: str = "ascent",
              ascent_rounds: int | None = None, nms_impl: str = "xla",
              resolve_impl: str = "auto", label_space: str = "index",
              plain: bool = False):
    """Peak-NMS seeds -> steepest-ascent basins resolved by the chase ->
    unseeded basins dropped and flooded from the seeded ones
    (``method="ascent"``), or the seeds flooded over the foreground
    (``method="flood"``); ``nms_impl`` selects where the seeds come from
    (module docstring). Returns int32 root-index labels
    (``ops.filter.size_filter_and_compact`` numbers them 1..K).
    ``resolve_impl``: "auto" and "pallas" run the kernel composition, "xla"
    the plain pointer jump of ``ascent_rounds`` rounds (module docstring);
    ``ascent_rounds`` is read by "xla" alone.

    ``peak_threshold`` and ``fg_threshold``: floats or 0-d float32 tensors
    on the maps' device (a calibrated threshold stays there: K1 and K5
    read it from device memory).

    ``plain=True`` runs the plain twins on whatever device the maps are on:
    the card's check of the kernels (``chip_smoke.py``)."""
    from tpuseg_torch.ops.nms import fused_peak_nms
    from tpuseg_torch.ops.peaks import peak_nms, radius3
    from tpuseg_torch.ops.resolve import (chase_resolve, chase_resolve_plain,
                                          flood_resolve, flood_resolve_plain)
    from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

    if method not in ("ascent", "flood"):
        raise ValueError(f"unknown watershed method {method!r}")
    if nms_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown nms_impl {nms_impl!r}")
    if label_space != "index":
        raise NotImplementedError(
            f"watershed(label_space={label_space!r}) is not ported (a TPU "
            "workaround; only 'index'); see ROADMAP.md")
    if resolve_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown resolve_impl {resolve_impl!r}")
    if fg_prob.numel() >= 2 ** 31:
        raise ValueError(f"volume {tuple(fg_prob.shape)} too large: labels "
                         "are int32 linear index + 1")
    seed, chase, flood = (
        (seed_chase_pass_plain, chase_resolve_plain, flood_resolve_plain)
        if plain else (seed_chase_pass, chase_resolve, flood_resolve))
    # peak_nms is both the plain NMS of nms_impl="xla" and the kernel's twin
    nms = fused_peak_nms if nms_impl == "pallas" and not plain else peak_nms

    fg_mask = threshold_mask(fg_prob, fg_threshold)
    radius = radius3(peak_radius)
    if resolve_impl == "xla":
        seeds = nms(peak_prob, peak_threshold, radius) & fg_mask
        if method == "flood":
            idx = linear_index(fg_prob.shape, fg_prob.device)
            return flood_resolve_plain(torch.where(seeds, idx + 1, 0),
                                       fg_mask, fg_prob, flood_iters)
        labels = ascent_labels(peak_prob, fg_mask, seed_mask=seeds,
                               rounds=ascent_rounds)
        # drop basins whose root (or where the jumps stopped) is no seed;
        # the flood absorbs them into the seeded ones
        root_is_seed = seeds.reshape(-1)[(labels - 1).clamp(min=0).reshape(
            -1).to(torch.int64)].reshape(labels.shape)
        labels = torch.where((labels > 0) & root_is_seed, labels, 0)
        return flood_resolve_plain(labels, fg_mask, fg_prob, flood_iters)
    if method == "ascent" and nms_impl == "xla":
        dirs, v = seed(peak_prob, fg_prob, peak_threshold, fg_threshold,
                       radius, h0=8)
        v = chase(v, dirs, fg_mask)
    else:
        seeds = nms(peak_prob, peak_threshold, radius) & fg_mask
        idx = linear_index(fg_prob.shape, fg_prob.device)
        if method == "flood":
            return flood(torch.where(seeds, idx + 1, 0), fg_mask, fg_prob,
                         flood_iters)
        dirs = steepest_dir_codes(peak_prob, fg_mask, self_sticky=seeds)
        v0 = torch.where(fg_mask & (dirs == 0),
                         torch.where(seeds, idx + 1, -(idx + 1)),
                         0).to(torch.int32)
        v = chase(v0, dirs, fg_mask)
    # the payload's sign says whether the basin root is a seed: unseeded
    # basins drop to 0 and are flooded from their seeded neighbours
    return flood(torch.clamp(v, min=0), fg_mask, fg_prob, flood_iters)
