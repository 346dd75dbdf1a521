"""Seeded watershed (port of ``tpuseg/ops/watershed.py``).

The port runs the TPU package's main-path composition
(``resolve_impl="auto"`` on a TPU, ``ops/watershed.py:268-286``): fused
seeding (K1, ``ops/seed.py``), the pointer chase to convergence (K2) and
the seeded flood that absorbs unseeded basins (K3, ``ops/resolve.py``). A
CUDA volume goes through the hand-written kernels, a CPU volume through
their plain twins. Labels are basin-root linear index + 1.

Not ported yet (``NotImplementedError``; see ROADMAP.md): ``method="flood"``,
``label_space="dense"``, ``nms_impl="pallas"`` and the XLA pointer-jump
resolve (``resolve_impl="xla"``, whose ``ascent_rounds`` cap has other
semantics).
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops.neighbors import NEIGHBORS_6, linear_index, shift


def steepest_dir_codes(potential, mask, self_sticky=None):
    """Direction code per voxel: 0 = self/root, 1..6 = NEIGHBORS_6 order —
    the argmax over {self} U 6 neighbours of (potential, linear index), with
    neighbours outside ``mask`` at -inf; ``self_sticky`` voxels keep 0."""
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
    code = torch.where(mask, best_code, 0)
    if self_sticky is not None:
        code = torch.where(self_sticky & mask, 0, code)
    return code.to(torch.int32)


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
              nms_impl: str = "xla", resolve_impl: str = "auto",
              label_space: str = "index", plain: bool = False):
    """Peak-NMS seeds -> steepest-ascent basins resolved by the chase ->
    unseeded basins dropped and flooded from the seeded ones. Returns int32
    root-index labels (``ops.filter.size_filter_and_compact`` numbers them
    1..K).

    ``plain=True`` runs the plain twins on whatever device the maps are on:
    the card's check of the kernels (``chip_smoke.py``)."""
    from tpuseg_torch.ops.peaks import radius3
    from tpuseg_torch.ops.resolve import (chase_resolve, chase_resolve_plain,
                                          flood_resolve, flood_resolve_plain)
    from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

    unported = {"method": (method, "ascent"), "nms_impl": (nms_impl, "xla"),
                "label_space": (label_space, "index")}
    for name, (got, want) in unported.items():
        if got != want:
            raise NotImplementedError(
                f"watershed({name}={got!r}) is not ported yet (only "
                f"{want!r}); see ROADMAP.md")
    if resolve_impl not in ("auto", "pallas"):
        raise NotImplementedError(
            f"watershed(resolve_impl={resolve_impl!r}) is not ported yet: the "
            "port runs the kernel path of 'auto'/'pallas'; see ROADMAP.md")
    if fg_prob.numel() >= 2 ** 31:
        raise ValueError(f"volume {tuple(fg_prob.shape)} too large: labels "
                         "are int32 linear index + 1")
    seed, chase, flood = (
        (seed_chase_pass_plain, chase_resolve_plain, flood_resolve_plain)
        if plain else (seed_chase_pass, chase_resolve, flood_resolve))

    fg_mask = fg_prob >= fg_threshold
    dirs, v = seed(peak_prob, fg_prob, peak_threshold, fg_threshold,
                   radius3(peak_radius), h0=8)
    v = chase(v, dirs, fg_mask)
    # the payload's sign says whether the basin root is a seed: unseeded
    # basins drop to 0 and are flooded from their seeded neighbours
    return flood(torch.clamp(v, min=0), fg_mask, fg_prob, flood_iters)
