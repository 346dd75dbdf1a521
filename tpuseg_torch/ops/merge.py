"""Saddle-ratio basin agglomeration (port of ``tpuseg/ops/merge.py``).

Adjacent basins ``a`` and ``b`` merge when

    saddle(a, b) >= ratio * min(peak[root_a], peak[root_b])

where ``saddle(a, b)`` is the highest pass over their shared interface (the
max over face-adjacent voxel pairs of the lower peak value of the two) and a
basin's maximum is its root voxel's value (labels are root linear index + 1).
Merging is the transitive closure over the passing edges; each group takes
its smallest label.

The TPU package sorts whole volumes of face pairs into fixed-size tables to
keep XLA's shapes static. Here each axis keeps only the faces between two
distinct non-zero labels, and one ``torch.unique`` over their int64 pair keys
``lo * 2^31 + hi`` (with inverse) groups them; ``scatter_reduce("amax")``
takes each pair's saddle. No whole volume is sorted.

Results are compact tensors of passing edges and table entries, not the TPU
package's SENT-padded slots; the entries are the same.
"""

from __future__ import annotations

import warnings

import torch

_KEY_SHIFT = 31


def saddle_merge_axis_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                            ratio: float, axis: int,
                            max_pairs: int = 1 << 17, basin_peak=None):
    """The passing merge edges across faces along ``axis``: int32
    ``(lo, hi)`` label pairs, ascending by ``(lo, hi)``. At most
    ``max_pairs`` distinct adjacent pairs are tested; beyond that the
    largest ``(lo, hi)`` pairs are dropped, with a warning.

    A basin's maximum is ``basin_peak[label - 1]``: by default the peak at
    its root (``peak_prob``'s linear index ``label - 1``); the sharded paths
    pass their groups' maxima, since their labels are not root indices into
    ``peak_prob``."""
    n = labels.shape[axis]
    a, b = labels.narrow(axis, 0, n - 1), labels.narrow(axis, 1, n - 1)
    face = (a > 0) & (b > 0) & (a != b)
    la, lb = a[face], b[face]
    peak = peak_prob.float()
    pa, pb = peak.narrow(axis, 0, n - 1)[face], peak.narrow(axis, 1, n - 1)[face]
    key = (torch.minimum(la, lb).to(torch.int64) << _KEY_SHIFT) \
        | torch.maximum(la, lb).to(torch.int64)
    pairs, inverse = torch.unique(key, sorted=True, return_inverse=True)
    if pairs.numel() > max_pairs:
        warnings.warn(
            f"saddle merge: {pairs.numel()} distinct adjacent label pairs on "
            f"axis {axis} exceed max_pairs={max_pairs}; largest pairs dropped "
            "— raise PostprocConfig.merge_max_pairs", stacklevel=2)
        keep = inverse < max_pairs
        pairs, inverse = pairs[:max_pairs], inverse[keep]
        pa, pb = pa[keep], pb[keep]
    saddle = torch.full(pairs.shape, float("-inf"), device=pairs.device)
    saddle = saddle.scatter_reduce(0, inverse, torch.minimum(pa, pb), "amax",
                                   include_self=False)
    lo = (pairs >> _KEY_SHIFT).to(torch.int32)
    hi = (pairs & ((1 << _KEY_SHIFT) - 1)).to(torch.int32)
    if basin_peak is None:
        basin_peak = peak.reshape(-1)
    floor = torch.minimum(basin_peak[lo.long() - 1], basin_peak[hi.long() - 1])
    passing = saddle >= torch.tensor(ratio, dtype=torch.float32,
                                     device=floor.device) * floor
    return lo[passing], hi[passing]


def saddle_merge_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                       ratio: float, max_pairs: int = 1 << 17):
    """The passing merge edges over all three axes, without closure or
    apply: int32 ``(e_lo, e_hi)``, axis 0's first. A pair adjacent on
    several axes appears once per axis; it merges iff any copy passes. The
    streamed path lifts these to global ids and closes them on the host."""
    parts = [saddle_merge_axis_edges(labels, peak_prob, ratio, a, max_pairs)
             for a in range(3)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def saddle_merge_core_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                            core, ratio: float, basin_peak: torch.Tensor,
                            max_pairs: int = 1 << 17):
    """The passing merge edges over the faces whose first voxel lies in a
    shard's core: the first ``core[d]`` planes along each dim ``d`` of
    ``labels`` and ``peak_prob``, which reach one plane further along a dim
    where a neighbour's core follows (that neighbour's first plane). Each
    axis tests the core grown along that axis only, so every face of the
    volume is tested by one shard, and a pair passes iff it passes on some
    shard. ``basin_peak`` as in ``saddle_merge_axis_edges``. Returns int32
    ``(e_lo, e_hi)``, axis 0's first."""
    parts = []
    for axis in range(3):
        lab, pk = labels, peak_prob
        for d, n in enumerate(core):
            if d != axis:
                lab, pk = lab.narrow(d, 0, n), pk.narrow(d, 0, n)
        parts.append(saddle_merge_axis_edges(lab, pk, ratio, axis, max_pairs,
                                             basin_peak))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def saddle_merge_table(labels: torch.Tensor, peak_prob: torch.Tensor,
                       ratio: float, max_pairs: int = 1 << 17):
    """Edges + union-find closure: ``(keys, roots)``, the ascending labels
    that take part in a passing edge and the smallest label of each one's
    merged group. Scatter-min hooks and pointer jumps run to their fixed
    point (one host read a round)."""
    u, v = saddle_merge_edges(labels, peak_prob, ratio, max_pairs)
    keys, inverse = torch.unique(torch.cat([u, v]), sorted=True,
                                 return_inverse=True)
    pu, pv = inverse[:u.numel()], inverse[u.numel():]
    parent = torch.arange(keys.numel(), device=keys.device)
    while True:
        ru, rv = parent[pu], parent[pv]
        hooked = parent.scatter_reduce(0, torch.maximum(ru, rv),
                                       torch.minimum(ru, rv), "amin")
        while True:                      # compress to a flat forest
            jumped = hooked[hooked]
            if torch.equal(jumped, hooked):
                break
            hooked = jumped
        if torch.equal(hooked, parent):
            break
        parent = hooked
    return keys, keys[parent]


def apply_merge_table(labels: torch.Tensor, keys: torch.Tensor,
                      roots: torch.Tensor) -> torch.Tensor:
    """Rename ``labels`` through the ``(keys, roots)`` table (one
    ``searchsorted`` over the sorted keys); labels not in ``keys`` pass
    through."""
    if keys.numel() == 0:
        return labels
    flat = labels.reshape(-1)
    pos = torch.searchsorted(keys, flat.to(keys.dtype)).clamp_(
        max=keys.numel() - 1)
    hit = (keys[pos] == flat) & (flat > 0)
    return torch.where(hit, roots[pos].to(labels.dtype),
                       flat).reshape(labels.shape)


def saddle_merge(labels: torch.Tensor, peak_prob: torch.Tensor, ratio: float,
                 max_pairs: int = 1 << 17) -> torch.Tensor:
    """Table + apply in one call: labels in, merged labels out."""
    keys, roots = saddle_merge_table(labels, peak_prob, ratio, max_pairs)
    return apply_merge_table(labels, keys, roots)
