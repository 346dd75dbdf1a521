"""Saddle-ratio basin agglomeration (port of ``tpuseg/ops/merge.py``).

Adjacent basins ``a`` and ``b`` merge when

    saddle(a, b) >= ratio * min(peak[root_a], peak[root_b])

where ``saddle(a, b)`` is the highest pass over their shared interface (the
max over face-adjacent voxel pairs of the lower peak value of the two) and a
basin's maximum is its root voxel's value (labels are root linear index + 1).
Merging is the transitive closure over the passing edges; each group takes
its smallest label.

As in the JAX package every shape is fixed, so the card runs the merge with
no host read: per axis, one sort of the int64 pair keys ``lo * 2^31 + hi``
of the whole face set (non-faces hold a key after every pair), a run count
(``cumsum``), each run's saddle by ``scatter_reduce("amax")``, and the first
``max_pairs`` runs looked up by ``searchsorted``. The edges come in the
reference's slot layout: ``max_pairs`` slots an axis, the i-th distinct pair
in ascending ``(lo, hi)`` order in slot i when it passes, ``SENT``
elsewhere; the largest pairs past ``max_pairs`` are dropped. The closure is
U1 (``ops/closure.py``).

The dropped count stays a device tensor. A count on the CPU warns at once;
one on the card is read by ``report_dropped`` after the labels (``cli.infer``
does), as the reference's ``cond_print`` reports asynchronously.
"""

from __future__ import annotations

import warnings

import torch

from tpuseg_torch.ops.closure import (SENTINELS, union_closure,
                                      union_closure_plain)

#: the label of an unused edge slot (``tpuseg.ops.merge._SENT``)
SENT = SENTINELS[torch.int32]
_KEY_SHIFT = 31
_NO_PAIR = 2 ** 63 - 1                  # the key of a voxel pair off a face


def _warn(n: int, axis: int, max_pairs: int) -> None:
    warnings.warn(
        f"saddle merge: {n} distinct adjacent label pairs on axis {axis} "
        f"exceed max_pairs={max_pairs}; largest pairs dropped — raise "
        "PostprocConfig.merge_max_pairs", stacklevel=3)


def report_dropped(dropped, max_pairs: int) -> None:
    """Warn, in the reference's words, for each axis whose distinct pairs
    exceeded ``max_pairs``, from a (3,) dropped count on the card: a host
    read, for after the labels. A count on the CPU warned when it was
    made."""
    if dropped is None or dropped.device.type == "cpu":
        return
    for axis, d in enumerate(dropped.reshape(-1).tolist()):
        if d > 0:
            _warn(d + max_pairs, axis, max_pairs)


def saddle_merge_axis_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                            ratio: float, axis: int,
                            max_pairs: int = 1 << 17, basin_peak=None):
    """The passing merge edges across faces along ``axis``: ``(lo, hi,
    dropped)``, int32 ``(max_pairs,)`` slots in the reference's layout
    (module docstring) and the 0-d int32 count of distinct adjacent pairs
    past ``max_pairs`` (on the CPU a count above 0 warns at once).

    A basin's maximum is ``basin_peak[label - 1]``: by default the peak at
    its root (``peak_prob``'s linear index ``label - 1``); the sharded paths
    pass their groups' maxima, since their labels are not root indices into
    ``peak_prob``."""
    dev = labels.device
    n = labels.shape[axis]
    a, b = labels.narrow(axis, 0, n - 1), labels.narrow(axis, 1, n - 1)
    face = (a > 0) & (b > 0) & (a != b)
    peak = peak_prob.float()
    key = torch.where(face, (torch.minimum(a, b).to(torch.int64) << _KEY_SHIFT)
                      | torch.maximum(a, b).to(torch.int64),
                      _NO_PAIR).reshape(-1)
    sad = torch.minimum(peak.narrow(axis, 0, n - 1),
                        peak.narrow(axis, 1, n - 1)).reshape(-1)
    lo = torch.full((max_pairs,), SENT, dtype=torch.int32, device=dev)
    hi = lo.clone()
    if key.numel() == 0:
        return lo, hi, torch.zeros((), dtype=torch.int32, device=dev)
    key, order = torch.sort(key)
    sad = sad[order]
    prev = torch.cat([key.new_full((1,), -1), key[:-1]])
    start = (key != prev) & (key != _NO_PAIR)
    run = torch.cumsum(start, 0)             # 1..P on the pairs' faces
    n_pairs = run[-1]
    # each pair's saddle: the max over its run (slot max_pairs takes the
    # dropped pairs and the non-faces)
    slot = torch.where(key != _NO_PAIR, run - 1, max_pairs).clamp_(
        max=max_pairs)
    saddle = torch.full((max_pairs + 1,), float("-inf"), device=dev)
    saddle = saddle.scatter_reduce(0, slot, sad, "amax")[:max_pairs]
    # the first face of the i-th pair, i = 1..max_pairs (N: no such pair)
    first = torch.searchsorted(run, torch.arange(1, max_pairs + 1,
                                                 device=dev))
    have = first < key.numel()
    pair = key[first.clamp_(max=key.numel() - 1)]
    lo = torch.where(have, pair >> _KEY_SHIFT, SENT).to(torch.int32)
    hi = torch.where(have, pair & ((1 << _KEY_SHIFT) - 1), SENT).to(
        torch.int32)
    if basin_peak is None:
        basin_peak = peak.reshape(-1)
    last = basin_peak.numel() - 1
    floor = torch.minimum(basin_peak[(lo.long() - 1).clamp(0, last)],
                          basin_peak[(hi.long() - 1).clamp(0, last)])
    ratio_t = torch.full((), ratio, dtype=torch.float32, device=dev)
    passing = have & (saddle >= ratio_t * floor)
    dropped = torch.clamp(n_pairs - max_pairs, min=0).to(torch.int32)
    if dev.type == "cpu" and dropped > 0:
        _warn(int(n_pairs), axis, max_pairs)
    return (torch.where(passing, lo, SENT), torch.where(passing, hi, SENT),
            dropped)


def _cat(parts):
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]))


def saddle_merge_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                       ratio: float, max_pairs: int = 1 << 17):
    """The passing merge edges over all three axes, without closure or
    apply: ``(e_lo, e_hi, dropped)``, int32 ``(3 * max_pairs,)`` slots (axis
    0's first) and the (3,) dropped counts, one an axis. A pair adjacent on
    several axes appears once per axis; it merges iff any copy passes. The
    streamed path lifts these to global ids and closes them on the host."""
    return _cat([saddle_merge_axis_edges(labels, peak_prob, ratio, a,
                                         max_pairs) for a in range(3)])


def saddle_merge_core_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                            core, ratio: float, basin_peak: torch.Tensor,
                            max_pairs: int = 1 << 17):
    """The passing merge edges over the faces whose first voxel lies in a
    shard's core: the first ``core[d]`` planes along each dim ``d`` of
    ``labels`` and ``peak_prob``, which reach one plane further along a dim
    where a neighbour's core follows (that neighbour's first plane). Each
    axis tests the core grown along that axis only, so every face of the
    volume is tested by one shard, and a pair passes iff it passes on some
    shard. ``basin_peak`` as in ``saddle_merge_axis_edges``. Returns
    ``saddle_merge_edges``'s ``(e_lo, e_hi, dropped)``."""
    parts = []
    for axis in range(3):
        lab, pk = labels, peak_prob
        for d, n in enumerate(core):
            if d != axis:
                lab, pk = lab.narrow(d, 0, n), pk.narrow(d, 0, n)
        parts.append(saddle_merge_axis_edges(lab, pk, ratio, axis, max_pairs,
                                             basin_peak))
    return _cat(parts)


def _merge_table(labels, peak_prob, ratio: float, max_pairs: int,
                 plain: bool):
    u, v, dropped = saddle_merge_edges(labels, peak_prob, ratio, max_pairs)
    keys, roots = (union_closure_plain if plain else union_closure)(u, v)
    return keys, roots, dropped


def saddle_merge_table(labels: torch.Tensor, peak_prob: torch.Tensor,
                       ratio: float, max_pairs: int = 1 << 17,
                       plain: bool = False):
    """Edges + union-find closure (U1; its twin with ``plain=True``):
    ``(keys, roots)``, the reference's table of ``6 * max_pairs`` slots:
    the passing edges' labels ascending, ``SENT``-padded, and the smallest
    label of each one's merged group."""
    return _merge_table(labels, peak_prob, ratio, max_pairs, plain)[:2]


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
                 max_pairs: int = 1 << 17, plain: bool = False
                 ) -> torch.Tensor:
    """Table + apply in one call: labels in, merged labels out. The (3,)
    dropped counts of the call stay on ``saddle_merge.last_dropped``
    (``report_dropped`` reads them)."""
    keys, roots, saddle_merge.last_dropped = _merge_table(
        labels, peak_prob, ratio, max_pairs, plain)
    return apply_merge_table(labels, keys, roots)


saddle_merge.last_dropped = None
