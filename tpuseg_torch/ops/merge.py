"""Saddle-ratio basin agglomeration (port of ``tpuseg/ops/merge.py``).

Adjacent basins ``a`` and ``b`` merge when

    saddle(a, b) >= ratio * min(peak[root_a], peak[root_b])

where ``saddle(a, b)`` is the highest pass over their shared interface (the
max over face-adjacent voxel pairs of the lower peak value of the two) and a
basin's maximum is its root voxel's value (labels are root linear index + 1).
Merging is the transitive closure over the passing edges; each group takes
its smallest label.

As in the JAX package every shape is fixed, so the card runs the merge with
no host read. The edges come in the reference's slot layout: ``max_pairs``
slots an axis, the i-th distinct pair in ascending ``(lo, hi)`` order in
slot i when it passes, ``SENT`` elsewhere; the largest pairs past
``max_pairs`` are dropped. Two versions build them:

* on the card, two hand-written kernels (``csrc/pairs.cu``): M1
  ``pair_aggregate`` puts every face's pair key ``lo * 2^31 + hi`` and its
  saddle into a hash table per axis (two passes over the labels: a count,
  then the inserts), and M2
  ``pair_slots`` orders the distinct pairs (a sort of ``2 * max_pairs``
  slots an axis, after a radix select where more pairs than that exist)
  and writes the slots. No volume-sized array is sorted or copied; the
  labels and peaks are read in place, in their own strides and dtype;
* the plain twin ``saddle_merge_axis_edges_plain`` (a CPU tensor, or
  ``plain=True``): per axis, one sort of the int64 pair keys of the whole
  face set (non-faces hold a key after every pair), a run count
  (``cumsum``), each run's saddle by ``scatter_reduce("amax")``, and the
  first ``max_pairs`` runs looked up by ``searchsorted``.

The closure is U1 (``ops/closure.py``). On the meta device the kernels'
wrappers return shapes only.

The dropped count stays a device tensor. A count on the CPU warns at once;
one on the card is read by ``report_dropped`` after the labels (``cli.infer``
does), as the reference's ``cond_print`` reports asynchronously.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import NamedTuple

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.closure import (SENTINELS, union_closure,
                                      union_closure_plain)

#: the label of an unused edge slot (``tpuseg.ops.merge._SENT``)
SENT = SENTINELS[torch.int32]
_KEY_SHIFT = 31
_NO_PAIR = 2 ** 63 - 1                  # the key of a voxel pair off a face
# csrc/pairs.cu: M1's counts (faces, distinct pairs; an axis each), M2's
# select state (ranks, prefixes, tickets, kept counts; then 3 x 65536 uint32
# histogram bins), the peak and basin dtypes
_M1_WORDS = 6
_M2_WORDS = 12 + 3 * 65536 // 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def saddle_merge_axis_edges_plain(labels: torch.Tensor,
                                  peak_prob: torch.Tensor, ratio: float,
                                  axis: int, max_pairs: int = 1 << 17,
                                  basin_peak=None):
    """The passing merge edges across faces along ``axis`` by the twin's
    sort of the whole face set (module docstring): ``(lo, hi, dropped)``,
    int32 ``(max_pairs,)`` slots in the reference's layout and the 0-d
    int32 count of distinct adjacent pairs past ``max_pairs`` (on the CPU a
    count above 0 warns at once).

    A basin's maximum is ``basin_peak[label - 1]`` (float32): by default
    the peak at its root (``peak_prob``'s linear index ``label - 1``); the
    sharded paths pass their groups' maxima, since their labels are not
    root indices into ``peak_prob``."""
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


class PairTable(NamedTuple):
    """M1's output, M2's input: ``geo`` (the 18 int64 of
    :func:`pair_geometry`), the three axes' hash tables (``keys``: int64
    pair keys, 0 in an empty slot; ``saddles``: the saddles' order-keeping
    int32 bits), ``meta`` (int64: each axis's faces, then its distinct
    pairs) and each axis's first ``S`` distinct pairs (``buf_keys``: (3, S)
    int64, ``INT64_MAX`` after the last; ``buf_slots``: their table
    slots)."""
    geo: list
    keys: torch.Tensor
    saddles: torch.Tensor
    meta: torch.Tensor
    buf_keys: torch.Tensor
    buf_slots: torch.Tensor


def pair_geometry(labels: torch.Tensor, peak_prob: torch.Tensor, core):
    """What M1 and M2 read of the shapes, as ``csrc/pairs.cu`` reads it:
    the extents, the labels' and peaks' strides (elements), ``core``, and
    each axis's first table slot and slot count (its face positions + 1:
    more than its distinct pairs can be). Axis a's faces start at voxels
    below ``core[d]`` along every dim ``d != a`` and below the last plane
    along ``a``."""
    n = tuple(labels.shape)
    alloc = [math.prod(n[d] - 1 if d == a else core[d] for d in range(3)) + 1
             for a in range(3)]
    off = [0, alloc[0], alloc[0] + alloc[1]]
    return [*n, *labels.stride(), *peak_prob.stride(), *core, *off, *alloc]


def _buffer_slots(max_pairs: int) -> int:
    """``S``: the distinct pairs an axis's buffer holds before M2 selects."""
    return 2 * max_pairs


def pair_aggregate(labels: torch.Tensor, peak_prob: torch.Tensor,
                   core=None, max_pairs: int = 1 << 17) -> PairTable:
    """M1: every face (in ``core``'s region, as :func:`pair_geometry`
    says; default the whole volume) into its axis's hash table: a pass over
    int32 ``labels`` that counts the faces, then one that inserts them with
    their saddles from ``peak_prob`` (float32, bfloat16 or float16, same
    shape; both read in place). CUDA tensors launch the kernels (a meta
    tensor gets the shapes only); anything else raises. ``.launches``
    counts the calls that launched."""
    n = tuple(labels.shape)
    core = n if core is None else tuple(core)
    dev = labels.device
    if labels.dtype != torch.int32 or labels.dim() != 3 \
            or peak_prob.shape != labels.shape \
            or peak_prob.dtype not in _DTYPES or peak_prob.device != dev \
            or len(core) != 3 or any(not 0 <= c <= m for c, m in zip(core, n)):
        raise ValueError(
            f"pair_aggregate needs int32 (D, H, W) labels and a float32/"
            f"bf16/fp16 peak map of their shape on one device, core within "
            f"it; got {labels.dtype} {n} on {dev}, {peak_prob.dtype} "
            f"{tuple(peak_prob.shape)} on {peak_prob.device}, core {core}")
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"pair_aggregate needs CUDA tensors, got {dev}")
    geo = pair_geometry(labels, peak_prob, core)
    if max(geo[15:]) >= 2 ** 31:
        raise ValueError(f"pair_aggregate: {max(geo[15:])} face positions "
                         "on an axis exceed the int32 slot index")
    size = sum(geo[15:])
    S = _buffer_slots(max_pairs)
    table = PairTable(
        geo, torch.empty(size, dtype=torch.int64, device=dev),
        torch.empty(size, dtype=torch.int32, device=dev),
        torch.zeros(_M1_WORDS, dtype=torch.int64, device=dev),
        torch.full((3, S), _NO_PAIR, dtype=torch.int64, device=dev),
        torch.empty((3, S), dtype=torch.int32, device=dev))
    if dev.type == "meta":
        return table
    err = _build.load().tpuseg_pair_aggregate(
        labels.data_ptr(), peak_prob.data_ptr(), _DTYPES[peak_prob.dtype],
        (ctypes.c_longlong * len(geo))(*geo), table.keys.data_ptr(),
        table.saddles.data_ptr(), table.meta.data_ptr(),
        table.buf_keys.data_ptr(), table.buf_slots.data_ptr(), S,
        _build.stream_ptr())
    _build.check(err, "pair_aggregate")
    pair_aggregate.launches += 1
    return table


pair_aggregate.launches = 0


def pair_slots(table: PairTable, basin: torch.Tensor, ratio: float,
               max_pairs: int = 1 << 17):
    """M2: ``saddle_merge_edges``'s ``(e_lo, e_hi, dropped)`` from M1's
    ``table``: each axis's ``max_pairs`` smallest pairs in ascending order
    (a radix select over its table first where its buffer overflowed), each
    kept where its saddle >= float32(``ratio``) * the smaller of its two
    basins' maxima, ``basin[label - 1]`` (a flat float32, or the peak map's
    dtype; indices clamped into it). Reads only what M1 wrote: it may run
    again on one table. ``.launches`` counts the calls that launched."""
    dev = table.keys.device
    S = table.buf_keys.shape[1]
    if S != _buffer_slots(max_pairs):
        raise ValueError(f"pair_slots: max_pairs={max_pairs} is not the "
                         f"table's (its buffer holds {S})")
    basin = basin.reshape(-1)
    if basin.dtype not in _DTYPES or basin.device != dev:
        raise ValueError(f"pair_slots needs a float basin on {dev}, got "
                         f"{basin.dtype} on {basin.device}")
    lo = torch.empty(3 * max_pairs, dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    dropped = torch.empty(3, dtype=torch.int32, device=dev)
    if dev.type == "meta":
        return lo, hi, dropped
    geo = (ctypes.c_longlong * len(table.geo))(*table.geo)
    lib = _build.load()
    sel = torch.zeros(_M2_WORDS, dtype=torch.int64, device=dev)
    err = lib.tpuseg_pair_select(
        geo, table.keys.data_ptr(), table.meta.data_ptr(), sel.data_ptr(),
        table.buf_keys.data_ptr(), table.buf_slots.data_ptr(), S, max_pairs,
        _build.stream_ptr())
    _build.check(err, "pair_slots (select)")
    keys, order = torch.sort(table.buf_keys, dim=1)
    err = lib.tpuseg_pair_slots(
        geo, keys.data_ptr(), order.data_ptr(), table.buf_slots.data_ptr(),
        table.saddles.data_ptr(), table.meta.data_ptr(), basin.data_ptr(),
        _DTYPES[basin.dtype], basin.numel(), ratio, max_pairs, S,
        lo.data_ptr(), hi.data_ptr(), dropped.data_ptr(), _build.stream_ptr())
    _build.check(err, "pair_slots")
    pair_slots.launches += 1
    return lo, hi, dropped


pair_slots.launches = 0


def _core_edges(labels, peak_prob, core, ratio: float, max_pairs: int,
                basin_peak, plain: bool):
    """``(e_lo, e_hi, dropped)`` over ``core``'s faces: M1 + M2 on a CUDA
    or meta tensor, the twin on the CPU or with ``plain=True``."""
    if plain or labels.device.type == "cpu":
        parts = []
        for axis in range(3):
            lab, pk = labels, peak_prob
            for d, n in enumerate(core):
                if d != axis:
                    lab, pk = lab.narrow(d, 0, n), pk.narrow(d, 0, n)
            parts.append(saddle_merge_axis_edges_plain(
                lab, pk, ratio, axis, max_pairs, basin_peak))
        return _cat(parts)
    if basin_peak is not None and basin_peak.dtype != torch.float32:
        raise ValueError(f"basin_peak must be float32, got {basin_peak.dtype}")
    table = pair_aggregate(labels, peak_prob, core, max_pairs)
    return pair_slots(table, peak_prob if basin_peak is None else basin_peak,
                      ratio, max_pairs)


def saddle_merge_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                       ratio: float, max_pairs: int = 1 << 17,
                       plain: bool = False):
    """The passing merge edges over all three axes, without closure or
    apply: ``(e_lo, e_hi, dropped)``, int32 ``(3 * max_pairs,)`` slots (axis
    0's first) and the (3,) dropped counts, one an axis. A pair adjacent on
    several axes appears once per axis; it merges iff any copy passes. The
    streamed path lifts these to global ids and closes them on the host.
    M1 + M2 on the card, the twin on the CPU or with ``plain=True``."""
    return _core_edges(labels, peak_prob, labels.shape, ratio, max_pairs,
                       None, plain)


def saddle_merge_core_edges(labels: torch.Tensor, peak_prob: torch.Tensor,
                            core, ratio: float, basin_peak: torch.Tensor,
                            max_pairs: int = 1 << 17, plain: bool = False):
    """The passing merge edges over the faces whose first voxel lies in a
    shard's core: the first ``core[d]`` planes along each dim ``d`` of
    ``labels`` and ``peak_prob``, which reach one plane further along a dim
    where a neighbour's core follows (that neighbour's first plane). Each
    axis tests the core grown along that axis only, so every face of the
    volume is tested by one shard, and a pair passes iff it passes on some
    shard. ``basin_peak`` as in ``saddle_merge_axis_edges_plain``. Returns
    ``saddle_merge_edges``'s ``(e_lo, e_hi, dropped)``; the kernels read
    the grown core in place (a view of the slab)."""
    return _core_edges(labels, peak_prob, tuple(core), ratio, max_pairs,
                       basin_peak, plain)


def _merge_table(labels, peak_prob, ratio: float, max_pairs: int,
                 plain: bool):
    u, v, dropped = saddle_merge_edges(labels, peak_prob, ratio, max_pairs,
                                       plain)
    keys, roots = (union_closure_plain if plain else union_closure)(u, v)
    return keys, roots, dropped


def saddle_merge_table(labels: torch.Tensor, peak_prob: torch.Tensor,
                       ratio: float, max_pairs: int = 1 << 17,
                       plain: bool = False):
    """Edges (M1 + M2) + union-find closure (U1; the twins with
    ``plain=True``):
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
