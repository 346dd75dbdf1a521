"""Cross-shard instance-label reconciliation (port of
``tpuseg/parallel/reconcile.py``).

Shards label instances with basin-root indices, so a basin whose root both
shards can see gets the same root on both; two problems remain:

1. An instance reaching farther than the halo can be named by two roots on
   the two sides of a boundary: ``boundary_edges`` pairs the two shards'
   labels of the same overlap plane, and one union-find closure over all
   shards' edges (``_closure_table``) renames each group to its smallest
   member.
2. Final labels must be dense 1..K over the whole volume, in the order of
   the single-device ``compact_relabel``.

Sharded inference names instances by packed ids ``rank * cap + slot + 1``
from bounded per-shard tables (``build_local_table``, ``rename_to_packed``);
each table entry carries its root's global coordinate, and
``packed_compact_labels`` unions, size-filters and numbers the groups by
their smallest coordinate. The JAX package keeps that coordinate as an
int32 pair (z plane, in-plane index) because it runs without 64-bit
integers; here it is one int64 linear index ``(gz * H + gy) * W + x``,
which orders the same.

The tables and edge lists are bounded (``shard_max_labels`` entries a shard,
the overlap planes' pairs), so the gathered union-find and the group
numbering run on the host (``ops/components.union_closure``); only the
renames of the label volumes run on the shards' devices. The functions take
a process's own shards' parts; under a process group the gathers span every
process, each one closes and numbers the same groups, and each renames its
own shards.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.ops.components import rename, union_closure
from tpuseg_torch.parallel.collectives import all_gather, pmax
from tpuseg_torch.parallel.multihost import is_distributed

#: the key of an unused table slot: after every coordinate
_SENTINEL = np.iinfo(np.int64).max


def _closure_table(edges: torch.Tensor):
    """Union-find closure over an (E, 2) edge list of label values; rows
    holding a 0 are inactive. Returns ``(keys, reps)`` on the edges' device:
    the ascending values of the active edges and the smallest value each
    one reaches."""
    active = (edges > 0).all(dim=1)
    e = edges[active].cpu().numpy().astype(np.int64)
    keys, reps = union_closure(e)
    return (torch.from_numpy(keys).to(edges.device),
            torch.from_numpy(reps).to(edges.device))


def apply_label_map(labels: torch.Tensor, keys: torch.Tensor,
                    reps: torch.Tensor) -> torch.Tensor:
    """Rename ``labels`` through the ``(keys -> reps)`` table; misses and
    background stay as they are."""
    if keys.numel() == 0:
        return labels
    vals = labels.to(keys.dtype)
    pos = torch.searchsorted(keys, vals.reshape(-1)).reshape(labels.shape)
    pos = pos.clamp_(max=keys.numel() - 1)
    hit = (keys[pos] == vals) & (labels > 0)
    return torch.where(hit, reps[pos].to(labels.dtype), labels)


def boundary_edges(overlap_mine: torch.Tensor,
                   overlap_theirs: torch.Tensor) -> torch.Tensor:
    """(E, 2) rename edges, each distinct pair once, from two labelings of
    the same overlap plane: the voxels both label, differently."""
    both = (overlap_mine > 0) & (overlap_theirs > 0) & \
        (overlap_mine != overlap_theirs)
    a = overlap_mine[both].to(torch.int64)
    b = overlap_theirs[both].to(torch.int64)
    key = torch.unique((a << 32) | b)
    return torch.stack([key >> 32, key & 0xFFFFFFFF], dim=-1).to(
        overlap_mine.dtype)


def _gathered_closure(edge_parts):
    """The closure of every shard's edges (``all_gather`` + one union-find
    on the host): ``(keys, reps)`` as numpy. Under a process group every
    process gathers, with or without edges of its own."""
    edges = [e for e in edge_parts if e is not None and e.numel()]
    if is_distributed():
        edges = [e.to(torch.int64) for e in edges] or [
            torch.zeros((0, 2), dtype=torch.int64)]
    elif not edges:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return union_closure(all_gather(edges).cpu().numpy().astype(np.int64))


def merge_boundary_labels(labels, overlap_mine, overlap_theirs=None) -> list:
    """Union labels that name the same voxel differently across shard
    boundaries; returns every shard's renamed core labels.

    ``labels``: the shards' core labels (a list). Either ``overlap_mine`` and
    ``overlap_theirs`` give one plane pair per shard (``None`` where a shard
    has no neighbour), or ``overlap_mine`` alone gives each shard a list of
    ``(mine, theirs)`` pairs, one per sharded dimension: all edges go
    through one closure, so corner-crossing instances merge
    transitively."""
    if overlap_theirs is not None:
        overlap_mine = [[] if m is None else [(m, t)]
                        for m, t in zip(overlap_mine, overlap_theirs)]
    keys, reps = _gathered_closure(
        [boundary_edges(m, t) for pairs in overlap_mine for m, t in pairs])
    out = []
    for lab in labels:
        k = torch.from_numpy(keys).to(lab.device)
        out.append(apply_label_map(lab, k, torch.from_numpy(reps).to(
            lab.device)))
    return out


def build_local_table(core: torch.Tensor, planes, cap: int):
    """Bounded sorted table of the distinct positive label ids in ``core``
    and in the boundary-overlap ``planes`` this shard sends to its
    neighbours (their ids must be packable even with no core voxel here;
    the owning neighbour counts them), with per-entry core voxel counts.

    Returns ``(table, counts, n_distinct)``: the ``cap`` smallest distinct
    ids (ascending, in ``core``'s dtype), each one's core voxel count
    (int64; the true run length, 0 for an id of the planes only), and the
    number of distinct ids before the cap (overflow past ``cap`` drops the
    largest ids)."""
    ids, counts = torch.unique(core[core > 0], return_counts=True)
    union = torch.unique(torch.cat([ids] + [p[p > 0] for p in planes]))
    table = union[:cap]
    table_counts = torch.zeros(table.numel(), dtype=torch.int64,
                               device=core.device)
    if table.numel():
        pos = torch.searchsorted(table, ids).clamp_(max=table.numel() - 1)
        hit = table[pos] == ids
        table_counts[pos[hit]] = counts[hit]
    return table, table_counts, int(union.numel())


def rename_to_packed(arr: torch.Tensor, table: torch.Tensor, shard_rank: int,
                     cap: int) -> torch.Tensor:
    """Local label ids to packed int32 ids ``shard_rank * cap + pos + 1``;
    background and ids missing from the bounded table (cap overflow) map to
    0, the dropped-instance semantics."""
    if table.numel() == 0:
        return torch.zeros(arr.shape, dtype=torch.int32, device=arr.device)
    vals = arr.to(table.dtype)
    pos = torch.searchsorted(table, vals.reshape(-1)).reshape(arr.shape)
    pos = pos.clamp_(max=table.numel() - 1)
    hit = (table[pos] == vals) & (arr > 0)
    return torch.where(hit, pos + (shard_rank * cap + 1), 0).to(torch.int32)


def global_lin(labels: torch.Tensor, ey: int, origin, H: int,
               W: int) -> torch.Tensor:
    """int64 linear indices ``(gz * H + gy) * W + x`` of the roots named by
    ``labels`` (``lin + 1`` over an extended slab ``ey`` rows high whose
    first voxel sits at global ``(z, y) = origin``): the order-preserving
    coordinates of the table entries."""
    v = labels.to(torch.int64) - 1
    x, t = v % W, v // W
    return ((t // ey + origin[0]) * H + t % ey + origin[1]) * W + x


def _gather_slots(parts, cap: int, fill, dtype=torch.int64) -> np.ndarray:
    """The shards' per-entry values in their packed slots: entry ``pos`` of
    shard ``r`` at index ``r * cap + pos``; unused slots hold ``fill``."""
    padded = [torch.cat([p.to(dtype), torch.full(
        (cap - p.numel(),), fill, dtype=dtype, device=p.device)])
        for p in parts]
    return all_gather(padded).cpu().numpy()


def _groups(keys, edge_parts, cap: int):
    """``(ids, inverse, keys)``: the packed ids of the used table slots,
    each one's group index (groups ascending by their closure
    representative) and its root coordinate."""
    gkey = _gather_slots(keys, cap, _SENTINEL)
    valid = np.flatnonzero(gkey < _SENTINEL)
    ids = valid + 1
    reps = rename(ids, *_gathered_closure(edge_parts))
    _, inverse = np.unique(reps, return_inverse=True)
    return ids, inverse.reshape(-1), gkey[valid]


def _renamed(core_packed, table_of_ids: np.ndarray) -> list:
    """Each shard's packed core labels through the dense rename table
    (indexed by packed id, 0 for background)."""
    out = []
    for p in core_packed:
        t = torch.from_numpy(table_of_ids).to(p.device)
        out.append(t[p.long()])
    return out


def packed_compact_labels(core_packed, keys, counts, edges, cap: int,
                          n_shards: int, min_size: int = 0) -> list:
    """Union packed labels across shard boundaries, size-filter on the
    global summed counts, and number the kept groups 1..K ascending by
    their smallest root coordinate: the single-device pipeline's
    ``size_filter_and_compact`` order (labels are root index + 1).

    ``core_packed``: each shard's packed core labels; ``keys``: each
    shard's table-entry root coordinates (int64); ``counts``: each entry's
    core voxel count; ``edges``: each shard's (E, 2) packed edges or
    ``None``. Returns each shard's int32 labels on its device."""
    ids, inverse, gkey = _groups(keys, edges, cap)
    gcnt = _gather_slots(counts, cap, 0)[ids - 1]
    n = int(inverse.max()) + 1 if ids.size else 0
    gmin = np.full(n, _SENTINEL, np.int64)
    np.minimum.at(gmin, inverse, gkey)
    size = np.zeros(n, np.int64)
    np.add.at(size, inverse, gcnt)
    kept = np.flatnonzero(size >= min_size)
    rank = np.zeros(n, np.int32)
    rank[kept[np.argsort(gmin[kept], kind="stable")]] = np.arange(
        1, kept.size + 1, dtype=np.int32)
    table = np.zeros(n_shards * cap + 1, np.int32)
    table[ids] = rank[inverse]
    return _renamed(core_packed, table)


def packed_groups(keys, edges, cap: int, n_shards: int, values=None):
    """The groups that the closure of ``edges`` makes of the packed ids:
    ``(group, gmin, gval)``, numpy. ``group`` (int32, indexed by packed id)
    numbers each used slot's group 1..G, ascending by the group's closure
    representative, 0 elsewhere; ``gmin`` is each group's smallest root
    coordinate. With ``values`` (each shard's per-entry float values, as
    ``keys``), ``gval`` is each group's value at the entry holding its
    ``gmin`` (the first such entry in packed order), else ``None``."""
    ids, inverse, gkey = _groups(keys, edges, cap)
    n = int(inverse.max()) + 1 if ids.size else 0
    gmin = np.full(n, _SENTINEL, np.int64)
    np.minimum.at(gmin, inverse, gkey)
    group = np.zeros(n_shards * cap + 1, np.int32)
    group[ids] = inverse + 1
    gval = None
    if values is not None:
        val = _gather_slots(values, cap, 0.0, torch.float32)[ids - 1]
        at_min = np.flatnonzero(gkey == gmin[inverse])
        g, first = np.unique(inverse[at_min], return_index=True)
        gval = np.zeros(n, np.float32)
        gval[g] = val[at_min[first]]
    return group, gmin, gval


def coord_labels(gmin: np.ndarray) -> np.ndarray:
    """int32 labels of the groups by their smallest root coordinate,
    ``gmin + 1``, indexed by group number (0: background); the coordinates
    must be below 2^31 - 1."""
    if gmin.size and gmin.max() >= 2 ** 31 - 1:
        raise ValueError("coordinate labels exceed the int32 range")
    return np.concatenate([[0], gmin + 1]).astype(np.int32)


def packed_merge_to_coord_labels(core_packed, keys, edges, cap: int,
                                 n_shards: int) -> list:
    """Union packed labels across shard boundaries and rename every group
    to ``min(key) + 1``, its smallest root coordinate as a label
    (``coord_labels``). The streamed x sharded composition
    (``infer/streaming.py``) gives chunk-local linear root indices as
    keys, so a y-sharded chunk comes out with the labels of the
    single-device chunk."""
    group, gmin, _ = packed_groups(keys, edges, cap, n_shards)
    return _renamed(core_packed, coord_labels(gmin)[group])


_RAISE = ("overflowed instances are dropped. Raise "
          "InferConfig.shard_max_labels.")
#: the JAX package's overflow reports, by where the tables were built
SHARD_OVERFLOW = ("tpuseg: sharded label table OVERFLOW — a shard has {c} "
                  "distinct labels > cap {cap}; " + _RAISE)
CHUNK_OVERFLOW = ("tpuseg: sharded-chunk label table OVERFLOW — {c} distinct "
                  "labels > cap {cap}; " + _RAISE)
COMPACT_OVERFLOW = ("tpuseg: global_compact_labels OVERFLOW — a shard has {c} "
                    "distinct labels > cap {cap}; " + _RAISE)


def report_overflow(n_distinct, cap: int, message: str) -> bool:
    """Print ``message`` when the largest per-shard distinct count (a
    ``pmax`` over the shards) exceeds ``cap``; returns whether it did."""
    c = int(pmax([torch.tensor(n) for n in n_distinct]))
    if c > cap:
        print(message.format(c=c, cap=cap))
    return c > cap


def global_compact_labels(labels, max_labels_per_shard: int = 4096,
                          min_size: int = 0) -> list:
    """Rename the shards' label volumes to one dense 1..K numbering,
    ascending in original id (``ops.compact_relabel``'s order), dropping
    ids whose total core voxel count over all shards is below
    ``min_size``.

    Each shard contributes its ``max_labels_per_shard`` smallest ids with
    their true voxel counts; ids past a shard's cap are dropped (0), and the
    overflow is reported."""
    cap = max_labels_per_shard
    tables, counts, n_distinct = [], [], []
    for lab in labels:
        ids, cnt = torch.unique(lab[lab > 0], return_counts=True)
        n_distinct.append(ids.numel())
        tables.append(ids[:cap].to(torch.int64))
        counts.append(cnt[:cap])
    report_overflow(n_distinct, cap, COMPACT_OVERFLOW)
    gt = all_gather(tables).cpu().numpy()
    gc = all_gather(counts).cpu().numpy()
    uniq, inverse = np.unique(gt, return_inverse=True)
    totals = np.zeros(uniq.size, np.int64)
    np.add.at(totals, inverse.reshape(-1), gc)
    kept = totals >= min_size
    rank = np.where(kept, np.cumsum(kept), 0)
    out = []
    for lab in labels:
        if not uniq.size:
            out.append(torch.zeros(lab.shape, dtype=torch.int32,
                                   device=lab.device))
            continue
        keys = torch.from_numpy(uniq).to(lab.device)
        vals = lab.to(torch.int64)
        pos = torch.searchsorted(keys, vals.reshape(-1)).reshape(lab.shape)
        pos = pos.clamp_(max=uniq.size - 1)
        hit = (keys[pos] == vals) & (lab > 0)
        ranks = torch.from_numpy(rank).to(lab.device)
        out.append(torch.where(hit, ranks[pos], 0).to(torch.int32))
    return out
