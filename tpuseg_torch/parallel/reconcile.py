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

Every table has a fixed size, as in the JAX package, and every step is a
sort, a ``searchsorted``, a scan or a scatter on the shards' devices, so a
process runs the reconciliation with no host read: a table holds ``cap``
slots (``shard_max_labels``) padded with a sentinel, an edge list one row
a voxel of the overlap planes (0 marks an inactive row), the closure is U1
(``ops/closure.py``) and the overflow count a 0-d tensor. The functions
take a process's own shards' parts; under a process group the gathers span
every process, each one closes and numbers the same groups, and each
renames its own shards.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops.closure import SENTINELS, union_closure
from tpuseg_torch.parallel.collectives import all_gather, pmax
from tpuseg_torch.parallel.multihost import is_distributed

#: the key of an unused table slot: after every coordinate
_SENTINEL = SENTINELS[torch.int64]
#: the id of an unused slot of an int32 label table
_SENT32 = SENTINELS[torch.int32]


def _closure_table(edges: torch.Tensor):
    """Union-find closure (U1) over an (E, 2) edge list of label values;
    rows holding a 0 are inactive. Returns ``(keys, reps)`` on the edges'
    device: the endpoint values of the active edges, ascending and
    sentinel-padded (2E slots), and the smallest value each one reaches."""
    return union_closure(edges[:, 0].contiguous(), edges[:, 1].contiguous())


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
    """(E, 2) rename edges from two labelings of the same overlap plane, a
    row a voxel: the voxels both label, differently; 0 elsewhere (inactive
    rows)."""
    both = (overlap_mine > 0) & (overlap_theirs > 0) & \
        (overlap_mine != overlap_theirs)
    return torch.stack([torch.where(both, overlap_mine, 0).reshape(-1),
                        torch.where(both, overlap_theirs, 0).reshape(-1)],
                       dim=-1)


def _gathered_closure(edge_parts, ragged: bool = False):
    """The closure of every shard's edges (``all_gather`` + U1): ``(keys,
    reps)`` on the first part's device, ``None`` without an edge list.
    Under a process group every process gathers; its parts must total the
    other processes' rows unless ``ragged``."""
    edges = [e for e in edge_parts if e is not None]
    if not edges:
        if not is_distributed():
            return None
        edges = [torch.zeros((0, 2), dtype=torch.int32)]
    return _closure_table(all_gather(edges, ragged=ragged))


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
    table = _gathered_closure(
        [boundary_edges(m, t) for pairs in overlap_mine for m, t in pairs],
        ragged=True)
    if table is None:
        return list(labels)
    return [apply_label_map(lab, *(t.to(lab.device) for t in table))
            for lab in labels]


def _distinct(s: torch.Tensor, n: int):
    """The first ``n`` distinct positive values of the ascending int32
    ``s`` (2^31 - 1 past the last), the position of each one's first copy in
    ``s`` (``s.numel()`` past the last), and the number of distinct
    positive values, a 0-d tensor. ``n + 1`` positions come back, so a
    run's length is the next position less its own."""
    prev = torch.cat([s.new_full((1,), -1), s[:-1]])
    run = torch.cumsum((s != prev) & (s > 0), 0)
    count = run[-1:].sum()
    first = torch.searchsorted(run, torch.arange(1, n + 2, device=s.device))
    vals = torch.where(first[:n] < s.numel(),
                       s[first[:n].clamp(max=max(s.numel() - 1, 0))], _SENT32)
    return vals, first, count


def build_local_table(core: torch.Tensor, planes, cap: int):
    """Bounded sorted table of the distinct positive label ids in ``core``
    and in the boundary-overlap ``planes`` this shard sends to its
    neighbours (their ids must be packable even with no core voxel here;
    the owning neighbour counts them), with per-entry core voxel counts.

    Returns ``(table, counts, n_distinct)``: the ``cap`` smallest distinct
    ids (ascending, in ``core``'s dtype, int32 labels; unused slots hold
    2^31 - 1), each one's core voxel count (int64; the true run length, 0
    for an id of the planes only and for an unused slot), and the number of
    distinct ids before the cap, a 0-d int64 tensor (overflow past ``cap``
    drops the largest ids)."""
    sc = torch.sort(core.reshape(-1)).values
    table, _, n_distinct = _distinct(sc, cap)
    if planes:
        sp = torch.sort(torch.cat([p.reshape(-1) for p in planes])).values
        prev = torch.cat([sp.new_full((1,), -1), sp[:-1]])
        pos = torch.searchsorted(sc, sp).clamp_(max=max(sc.numel() - 1, 0))
        extra = (sp != prev) & (sp > 0) & (sc[pos] != sp)
        n_distinct = n_distinct + extra.sum()
        # the union's cap smallest lie among each part's cap smallest
        more = torch.sort(torch.where(extra, sp, _SENT32)).values[:cap]
        table = torch.sort(torch.cat([table, more])).values[:cap]
    counts = (torch.searchsorted(sc, table, right=True)
              - torch.searchsorted(sc, table))
    return table, counts, n_distinct


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
    first voxel sits at global ``(z, y) = origin``, ints or 0-d int64
    tensors): the order-preserving coordinates of the table entries; an
    unused table slot (2^31 - 1) gets the sentinel."""
    v = labels.to(torch.int64) - 1
    x, t = v % W, v // W
    lin = ((t // ey + origin[0]) * H + t % ey + origin[1]) * W + x
    return torch.where(labels == _SENT32, _SENTINEL, lin)


def _groups(keys, edge_parts):
    """``(gkey, group)`` over the gathered table slots: each slot's root
    coordinate (the sentinel where unused) and its group number 1..G
    (groups ascending by their closure representative, 0 where unused);
    slot ``i`` is packed id ``i + 1``."""
    gkey = all_gather(keys)
    m = gkey.numel()
    dev = gkey.device
    rep = torch.arange(1, m + 1, dtype=torch.int32, device=dev)
    table = _gathered_closure(edge_parts)
    if table is not None:
        rep = apply_label_map(rep, *(t.to(dev) for t in table))
    rep = torch.where(gkey != _SENTINEL, rep, _SENT32)
    srep, order = torch.sort(rep, stable=True)
    prev = torch.cat([srep.new_full((1,), -1), srep[:-1]])
    number = torch.cumsum((srep != prev) & (srep != _SENT32), 0)
    group = torch.zeros(m, dtype=torch.int32, device=dev).scatter_(
        0, order, torch.where(srep != _SENT32, number, 0).to(torch.int32))
    return gkey, group


def _group_min(gkey, group):
    """Each group's smallest root coordinate, indexed by group number - 1
    (the sentinel past the last group)."""
    m = gkey.numel()
    return torch.full((m + 1,), _SENTINEL, dtype=torch.int64,
                      device=gkey.device).scatter_reduce(
        0, group.long(), gkey, "amin")[1:]


def _renamed(core_packed, by_slot: torch.Tensor) -> list:
    """Each shard's packed core labels through ``by_slot`` (the label of
    each table slot; packed id 0, the background, maps to 0)."""
    table = torch.cat([by_slot.new_zeros(1), by_slot])
    return [table.to(p.device)[p.long()] for p in core_packed]


def packed_compact_labels(core_packed, keys, counts, edges, cap: int,
                          n_shards: int, min_size: int = 0) -> list:
    """Union packed labels across shard boundaries, size-filter on the
    global summed counts, and number the kept groups 1..K ascending by
    their smallest root coordinate: the single-device pipeline's
    ``size_filter_and_compact`` order (labels are root index + 1).

    ``core_packed``: each shard's packed core labels; ``keys``: each
    shard's ``cap`` table-slot root coordinates (int64, ``global_lin``;
    the sentinel where unused); ``counts``: each slot's core voxel count;
    ``edges``: each shard's (E, 2) packed edges or ``None``. Returns each
    shard's int32 labels on its device."""
    gkey, group = _groups(keys, edges)
    m = gkey.numel()
    gcnt = all_gather([c.to(torch.int64) for c in counts])
    size = torch.zeros(m + 1, dtype=torch.int64, device=gkey.device)
    size = size.scatter_add_(0, group.long(), gcnt)[1:]
    gmin = _group_min(gkey, group)
    kept = torch.where((gmin != _SENTINEL) & (size >= min_size), gmin,
                       _SENTINEL)
    # ties (none between groups with distinct roots) by group number, as a
    # stable sort keeps them
    skept, order = torch.sort(kept, stable=True)
    rank = torch.zeros(m, dtype=torch.int32, device=gkey.device).scatter_(
        0, order, torch.where(skept != _SENTINEL, torch.arange(
            1, m + 1, dtype=torch.int32, device=gkey.device), 0))
    by_slot = torch.where(group > 0, rank[(group.long() - 1).clamp(min=0)], 0)
    return _renamed(core_packed, by_slot)


def packed_groups(keys, edges, cap: int, n_shards: int, values=None):
    """The groups that the closure of ``edges`` makes of the packed ids:
    ``(group, gmin, gval)``, on the first shard's device. ``group`` (int32,
    indexed by packed id, ``n_shards * cap + 1`` entries) numbers each used
    slot's group 1..G, ascending by the group's closure representative, 0
    elsewhere; ``gmin`` (int64, indexed by group number - 1) is each
    group's smallest root coordinate, the sentinel past the last group.
    With ``values`` (each shard's per-slot float values, as ``keys``),
    ``gval`` is each group's value at the slot holding its ``gmin`` (the
    first such slot in packed order), else ``None``."""
    gkey, group = _groups(keys, edges)
    m = gkey.numel()
    dev = gkey.device
    gmin = _group_min(gkey, group)
    gval = None
    if values is not None:
        val = all_gather([v.to(torch.float32) for v in values])
        g = group.long()
        at_min = (g > 0) & (gkey == gmin[(g - 1).clamp(min=0)])
        slot = torch.arange(m, device=dev)
        first = torch.full((m + 1,), m, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, torch.where(at_min, g, 0),
                                     torch.where(at_min, slot, m), "amin")[1:]
        gval = torch.where(first < m, val[first.clamp(max=m - 1)], 0.0)
    return torch.cat([group.new_zeros(1), group]), gmin, gval


def coord_labels(gmin: torch.Tensor) -> torch.Tensor:
    """int32 labels of the groups by their smallest root coordinate,
    ``gmin + 1``, indexed by group number (0: background and the unused
    numbers); the coordinates must be below 2^31 - 1 (the streamed chunk
    checks it from its shape)."""
    lab = torch.where(gmin != _SENTINEL, gmin + 1, 0).to(torch.int32)
    return torch.cat([lab.new_zeros(1), lab])


def packed_merge_to_coord_labels(core_packed, keys, edges, cap: int,
                                 n_shards: int) -> list:
    """Union packed labels across shard boundaries and rename every group
    to ``min(key) + 1``, its smallest root coordinate as a label
    (``coord_labels``). The streamed x sharded composition
    (``infer/streaming.py``) gives chunk-local linear root indices as
    keys, so a y-sharded chunk comes out with the labels of the
    single-device chunk."""
    group, gmin, _ = packed_groups(keys, edges, cap, n_shards)
    return _renamed(core_packed, coord_labels(gmin)[group[1:].long()])


_RAISE = ("overflowed instances are dropped. Raise "
          "InferConfig.shard_max_labels.")
#: the JAX package's overflow reports, by where the tables were built
SHARD_OVERFLOW = ("tpuseg: sharded label table OVERFLOW — a shard has {c} "
                  "distinct labels > cap {cap}; " + _RAISE)
CHUNK_OVERFLOW = ("tpuseg: sharded-chunk label table OVERFLOW — {c} distinct "
                  "labels > cap {cap}; " + _RAISE)
COMPACT_OVERFLOW = ("tpuseg: global_compact_labels OVERFLOW — a shard has {c} "
                    "distinct labels > cap {cap}; " + _RAISE)


def print_overflow(count, cap: int, message: str) -> bool:
    """Print ``message`` if ``count`` (``report_overflow``'s) exceeds
    ``cap``, and return whether it did: a host read, for after the labels.
    A count on the CPU was printed when it was made."""
    if count is None or count.device.type == "cpu":
        return False
    c = int(count)
    if c > cap:
        print(message.format(c=c, cap=cap))
    return c > cap


def report_overflow(n_distinct, cap: int, message: str) -> torch.Tensor:
    """The largest per-shard distinct count (a ``pmax`` over the shards),
    a 0-d tensor. On the CPU ``message`` is printed at once when it
    exceeds ``cap``; a count on the card stays there for
    ``print_overflow``, as the reference's ``cond_print`` reports
    asynchronously."""
    c = pmax([n.reshape(()).to(torch.int64) for n in n_distinct])
    if c.device.type == "cpu" and c > cap:
        print(message.format(c=int(c), cap=cap))
    return c


def global_compact_labels(labels, max_labels_per_shard: int = 4096,
                          min_size: int = 0) -> list:
    """Rename the shards' label volumes to one dense 1..K numbering,
    ascending in original id (``ops.compact_relabel``'s order), dropping
    ids whose total core voxel count over all shards is below
    ``min_size``.

    Each shard contributes its ``max_labels_per_shard`` smallest ids with
    their true voxel counts; ids past a shard's cap are dropped (0), and the
    overflow is reported (``report_overflow``; the count of the last call
    stays on ``global_compact_labels.last_overflow``)."""
    cap = max_labels_per_shard
    tables, counts, n_distinct = [], [], []
    for lab in labels:
        s = torch.sort(lab.reshape(-1).to(torch.int32)).values
        ids, first, n = _distinct(s, cap)
        n_distinct.append(n)
        tables.append(ids)
        # a run ends at the next id's first copy, dropped or not
        counts.append(torch.where(first[:cap] < s.numel(),
                                  first[1:] - first[:cap], 0))
    global_compact_labels.last_overflow = report_overflow(
        n_distinct, cap, COMPACT_OVERFLOW)
    gt, order = torch.sort(all_gather(tables))
    gc = all_gather(counts)[order]
    prev = torch.cat([gt.new_full((1,), -1), gt[:-1]])
    valid = (gt > 0) & (gt != _SENT32)
    new = (gt != prev) & valid
    run = torch.cumsum(new, 0)
    totals = torch.zeros(gt.numel() + 1, dtype=torch.int64, device=gt.device)
    totals = totals.scatter_add_(0, torch.where(valid, run, 0),
                                 torch.where(valid, gc, 0))
    kept = valid & (totals[run] >= min_size)
    rank = torch.where(kept, torch.cumsum(new & kept, 0), 0).to(torch.int32)
    out = []
    for lab in labels:
        keys, ranks = gt.to(lab.device), rank.to(lab.device)
        vals = lab.to(torch.int32)
        pos = torch.searchsorted(keys, vals.reshape(-1)).reshape(lab.shape)
        pos = pos.clamp_(max=keys.numel() - 1)
        hit = (keys[pos] == vals) & (lab > 0)
        out.append(torch.where(hit, ranks[pos], 0))
    return out


global_compact_labels.last_overflow = None
