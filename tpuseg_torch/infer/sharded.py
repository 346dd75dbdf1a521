"""Sharded whole-volume inference (port of ``tpuseg/infer/sharded.py``,
without its multislice mesh helpers), in one process or in several.

The volume is split over a 1-D ``("z",)`` or 2-D ``("z", "y")`` mesh
(``parallel/mesh.py``); shard ``(iz, iy)`` owns the slab
``[iz * Dl, (iz + 1) * Dl) x [iy * Hl, (iy + 1) * Hl)``. The JAX package
runs one ``shard_map`` body on every device at once, with collectives in
the middle of it. A process runs its own shards (all of them without a
process group, ``mesh.local_ranks()`` under one) one after another, so the
body is split at each collective into stages; a stage that needs every
shard's output runs for all of a process's shards before the next, and its
collective (``parallel/collectives.py``) then spans the processes:

1. halo exchange (``infer.shard_halo`` planes, y first, then z) and the
   normalization scalars from the summed histograms of the cores;
2. the tiled net sweep of each extended slab (normalizing per tile block)
   and the sigmoid, in the sweep's dtype as in the one-shot path;
3. the fake (edge-replicated) halo of the outermost shards zeroed, so that
   the volume's faces behave as in the one-shot path;
4. with ``postproc.fg_target_fraction > 0``, the volume-matched threshold
   from the summed fg histograms of the cores (cores partition the volume:
   every shard's fg is needed before any watershed); without it, stages
   2-6 run for one shard at a time, which keeps only its labels;
5. the watershed (K1-K3, K5 under ``nms_impl="pallas"``) of each extended
   slab: labels are the slab's root index + 1, so a basin both shards see
   whole gets the same root on both;
6. each shard's bounded table of its core's and overlap planes' ids
   (``shard_max_labels``; the overflow count stays on the device), their
   global root coordinates, packed ids, and the edges between its packing
   and its lower neighbour's of the same overlap plane;
7. with ``postproc.merge_saddle_ratio > 0``, the saddle merge of the
   reconciled basins, each shard testing the faces of its core
   (``_merge_edges``): the one-shot merge test on the same basins;
8. one closure over all edges, the size filter on the global counts, and
   the dense numbering 1..K by smallest root coordinate
   (``packed_compact_labels``).

The labels equal the one-shot ``make_infer_fn``'s elementwise for every
instance whose basin fits within ``shard_halo`` of a boundary. (The JAX
package merges each extended slab before the reconciliation, where a
merge chain can reach a basin the slab cuts off; the two agree where
instances and merge chains fit within the halo.)

Every table and edge list has a fixed size (``parallel/reconcile.py``),
the closures run on U1 and the counts (samples, table overflow, the merge's
dropped pairs) come from shapes or stay on the device, so in one process
``infer`` enqueues the whole call with no host read: the host reads once,
when ``unshard`` copies the labels out, and ``report_sharded_counts`` then
prints what the call kept on the device.

Root coordinates are int64 linear indices ``(gz * H + gy) * W + x``
(``z_offset`` places the stack inside a larger volume); the bound this path
keeps is the int32 labels of the watershed: an extended slab must hold
fewer than 2^31 voxels (``ops/watershed.py`` raises otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.core import Config
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.data.normalize import bin_counts, percentiles_from_counts
from tpuseg_torch.infer.pipeline import make_apply_fn
from tpuseg_torch.infer.tiles import tiled_forward
from tpuseg_torch.ops.calibrate import fg_bin_counts, threshold_from_counts
from tpuseg_torch.ops.merge import (SENT, report_dropped,
                                    saddle_merge_core_edges)
from tpuseg_torch.ops.watershed import watershed
from tpuseg_torch.parallel.collectives import (all_gather, pmax, pmin,
                                               ppermute, psum)
from tpuseg_torch.parallel.halo import exchange_mesh_halo
from tpuseg_torch.parallel.mesh import Mesh, replicas
from tpuseg_torch.parallel.multihost import is_distributed, put_global
from tpuseg_torch.parallel.reconcile import (SHARD_OVERFLOW, boundary_edges,
                                             build_local_table, global_lin,
                                             packed_compact_labels,
                                             packed_groups, print_overflow,
                                             rename_to_packed,
                                             report_overflow)


def global_histogram_percentile(slabs, pcts, bins: int = 4096,
                                sample_stride: int = 1, n_shards=None):
    """Percentiles of the whole volume from its shards' slabs: the global
    min and max, then the summed int64 histograms of every
    ``sample_stride``-th x voxel (x is never sharded, so the shards sample
    the one-shot path's voxels). ``slabs``: this process's shards, of one
    shape, out of ``n_shards`` in all (default: these). Returns
    ``(p_lo, p_hi)``, 0-d float32 on the first shard's device, equal to
    the one-shot ``histogram_percentile_scalars``."""
    slabs = [s.float() for s in slabs]
    lo = pmin([s.min() for s in slabs])
    span = torch.clamp(pmax([s.max() for s in slabs]) - lo, min=1e-12)
    hists = []
    for s in slabs:
        sample = s[..., ::sample_stride] if sample_stride > 1 else s
        hists.append(bin_counts(sample.reshape(1, -1), lo[None].to(s.device),
                                span[None].to(s.device), bins))
    # every shard has one shape: the count comes from it
    n = sample.numel() * (n_shards or len(slabs))
    vals = percentiles_from_counts(psum(hists), n, lo[None], span[None],
                                   pcts, bins)
    return tuple(vals[:, 0].to(lo.device))


def _core(t: torch.Tensor, halo: int, sizes) -> torch.Tensor:
    """The core of an extended slab: ``halo`` planes off each end of each
    sharded dim (``sizes``: the core extents along dims 0, 1, ...)."""
    for d, n in enumerate(sizes):
        t = t.narrow(d, halo, n)
    return t


def _merge_edges(parts, keys, edges, cap: int, n_shards: int, pp,
                 core, plain: bool):
    """The saddle merge of the reconciled basins, as packed-id edges: the
    overlap-plane closure groups the shards' basins (a basin two shards
    see whole is one group, named by its root); each group's maximum is
    the peak at its smallest root coordinate, read by the shard whose table
    holds it; each shard tests the faces whose first voxel lies in its
    core (``saddle_merge_core_edges``) on its grown core in group labels,
    and every passing pair comes back as an edge between one packed id of
    each group (0 on an unused slot). The union of the shards' tests is
    the one-shot merge test on the same basins. Returns the shards' (E, 2)
    edges and the largest dropped count of each axis over them."""
    group, _, gval = packed_groups(keys, edges, cap, n_shards,
                                   values=[t["peak"] for t in parts])
    m = group.numel()
    # the smallest packed id of each group (group 0: the background's 0)
    rep = torch.full((m,), m, dtype=torch.int32, device=group.device)
    rep = rep.scatter_reduce(0, group.long(), torch.arange(
        m, dtype=torch.int32, device=group.device), "amin")
    out, dropped = [], []
    for t in parts:
        dev = t["packed"].device
        g = group.to(dev)[t["packed"].long()]
        lo, hi, d = saddle_merge_core_edges(
            g, t.pop("grown_peak"), core, pp.merge_saddle_ratio,
            gval.to(dev), max_pairs=pp.merge_max_pairs, plain=plain)
        r = rep.to(dev)
        out.append(torch.stack([
            torch.where(e != SENT, r[e.long().clamp_(max=m - 1)], 0)
            for e in (lo, hi)], dim=-1))
        dropped.append(d)
    return out, pmax(dropped)


def make_sharded_infer_fn(model, cfg: Config, mesh: Mesh,
                          normalize: bool = True, plain: bool = False):
    """``infer(shards, z_offset=0) -> labels``: ``shards`` are this
    process's per-shard slabs in the order of ``mesh.local_ranks()`` (every
    shard in rank order without a process group; ``shard_volume``), each on
    its device; the result is each of those shards' int32 core labels on
    its device (``unshard`` puts every process's together). ``z_offset`` is
    the global z of the stack's first plane, for a block inside a larger
    volume. Under a process group every process calls ``infer`` on its
    shards.

    ``model`` maps (B, 1, d, h, w) blocks to ``{"fg_logits",
    "peak_logits"}``; it is copied to each shard device it is not on. The
    sweep's forward is ``make_apply_fn``'s (``apply_impl="fused"`` runs
    K4). ``plain=True`` runs the kernels' twins on the same devices (the
    card's check of the kernels).

    A call keeps its counts on the device, on ``infer``: ``last_overflow``
    (the largest per-shard distinct count, 0-d) and, with the merge on,
    ``last_merge_dropped`` (the largest per-axis dropped count, (3,));
    ``report_sharded_counts(infer)`` prints them after the labels."""
    axes = tuple(mesh.axis_names)
    if not 1 <= len(axes) <= 2:
        raise ValueError(f"mesh must have 1 or 2 spatial axes, got {axes}")
    nper = tuple(mesh.shape[a] for a in axes)
    cap = cfg.infer.shard_max_labels
    if mesh.size * cap >= 2 ** 31:
        raise ValueError(f"{mesh.size} shards x shard_max_labels {cap} "
                         "exceed the int32 packed ids")
    halo = cfg.infer.shard_halo
    compute_dtype = resolve(cfg.infer.compute_dtype)
    pp = cfg.postproc
    local = mesh.local_ranks()
    apply_fns = {d: make_apply_fn(m, cfg, plain) for d, m in replicas(
        model, [mesh.devices[r] for r in local]).items()}
    coords = [mesh.coords(r) for r in range(mesh.size)]

    @torch.inference_mode()
    def infer(shards, z_offset: int = 0):
        if len(shards) != len(local):
            raise ValueError(f"{len(shards)} shards for this process's "
                             f"{len(local)} of the mesh")
        shape = tuple(shards[0].shape)
        if any(tuple(s.shape) != shape for s in shards):
            raise ValueError("shards differ in shape: "
                             f"{[tuple(s.shape) for s in shards]}")
        sizes = shape[:len(axes)]                 # core extents, dims 0..
        # the core, grown by the overlap plane along each cut dim
        grow = [n + (nper[d] > 1) for d, n in enumerate(sizes)]
        dl, hl, W = shape
        H = hl * (nper[1] if len(axes) == 2 else 1)
        merging = pp.merge_saddle_ratio > 0

        # 1: halo exchange (y, then z) + global normalization scalars
        slabs = [s.float() for s in shards]
        ext = dict(zip(local, exchange_mesh_halo(slabs, halo, mesh)))
        preprocess = dict.fromkeys(local)
        if normalize:
            p_lo, p_hi = global_histogram_percentile(
                slabs, cfg.data.normalize_pcts,
                sample_stride=cfg.data.normalize_sample_stride,
                n_shards=mesh.size)
            for r, s in zip(local, slabs):
                lo = p_lo.to(s.device)
                span = torch.clamp(p_hi.to(s.device) - lo, min=1e-6)
                preprocess[r] = (lambda b, lo=lo, span=span:
                                 torch.clamp((b - lo) / span, 0.0, 1.0))
        del slabs

        def sweep(r):
            """2-3: the sweep + sigmoid of shard ``r``, fake halo zeroed."""
            out = tiled_forward(apply_fns[ext[r].device], ext[r],
                                tile=cfg.infer.tile, halo=cfg.infer.halo,
                                tile_batch=cfg.infer.tile_batch,
                                compute_dtype=compute_dtype,
                                preprocess=preprocess[r])
            ext[r] = None
            f = torch.sigmoid(out["fg_logits"])
            p = torch.sigmoid(out["peak_logits"])
            del out
            for d, n in enumerate(sizes):
                if coords[r][d] == 0:
                    f.narrow(d, 0, halo).zero_()
                    p.narrow(d, 0, halo).zero_()
                if coords[r][d] == nper[d] - 1:
                    f.narrow(d, halo + n, halo).zero_()
                    p.narrow(d, halo + n, halo).zero_()
            return f, p

        def label(r, f, p, fg_threshold):
            """5-6: the watershed of shard ``r``'s extended slab, its
            bounded table of its core's and overlap planes' ids (the
            overlap plane along dim d: my copy of the next shard's first
            core plane, cropped to the core in the other cut dim), the
            entries' root coordinates and core counts, and its grown core
            in packed ids; to merge, also each entry's root peak and the
            grown core's peaks."""
            lab = watershed(f, p, peak_threshold=pp.peak_threshold,
                            fg_threshold=fg_threshold,
                            peak_radius=pp.nms_radius,
                            flood_iters=pp.flood_iters, method=pp.method,
                            ascent_rounds=pp.ascent_rounds,
                            nms_impl=pp.nms_impl,
                            resolve_impl=pp.resolve_impl,
                            label_space="index", plain=plain)
            del f
            grown = _core(lab, halo, grow)
            planes = [_core(grown.select(d, n), 0, sizes[:d] + sizes[d + 1:])
                      for d, n in enumerate(sizes) if nper[d] > 1]
            table, counts, nd = build_local_table(_core(grown, 0, sizes),
                                                  planes, cap)
            origin = (coords[r][0] * dl - halo + z_offset,
                      coords[r][1] * hl - halo if len(axes) == 2 else 0)
            out = {"key": global_lin(table, lab.shape[1], origin, H, W),
                   "count": counts, "n_distinct": nd,
                   "packed": rename_to_packed(grown, table, r, cap)}
            if merging:                   # an unused slot reads any voxel
                out["peak"] = p.reshape(-1)[(table.long() - 1).clamp_(
                    0, p.numel() - 1)]
                out["grown_peak"] = _core(p, halo, grow).clone()
            return out

        # 2-6 for each shard in turn; with a calibration, every shard's fg
        # before any watershed (4: the volume-matched threshold over the
        # cores' summed histograms)
        if pp.fg_target_fraction > 0:
            probs = {r: sweep(r) for r in local}
            stride = cfg.data.normalize_sample_stride
            hists = []
            for f, _ in probs.values():
                core = _core(f, halo, sizes)
                if stride > 1:
                    core = core[..., ::stride]
                hists.append(fg_bin_counts(core))
            n = core.numel() * mesh.size          # the cores' one shape
            # a 0-d float32 tensor, as the reference's traced threshold:
            # a bf16 map compares with it in float32 (ops.watershed)
            thr = threshold_from_counts(psum(hists), n, pp.fg_target_fraction)
            parts = {}
            for r in local:
                f, p = probs.pop(r)
                parts[r] = label(r, f, p, thr.to(f.device))
        else:
            parts = {r: label(r, *sweep(r), pp.fg_threshold) for r in local}
        infer.last_overflow = report_overflow(
            [t["n_distinct"] for t in parts.values()], cap, SHARD_OVERFLOW)
        keys = [t["key"] for t in parts.values()]
        core_p = {r: _core(t["packed"], 0, sizes) for r, t in parts.items()}

        # the overlap-plane edges of every cut dim feed one closure
        # (corner-crossing instances merge transitively); every shard gives
        # one plane's rows a cut dim (none active without a lower
        # neighbour: ppermute's zeros), so the processes' parts match
        edges = []
        for d, a in enumerate(axes):
            if nper[d] <= 1:
                continue
            for line in mesh.lines(a):
                theirs = ppermute(
                    [_core(parts[r]["packed"].select(d, sizes[d]), 0,
                           sizes[:d] + sizes[d + 1:]) if r in parts else None
                     for r in line],
                    [(j, j + 1) for j in range(len(line) - 1)],
                    [mesh.processes[r] for r in line])
                for j, r in enumerate(line):
                    if r in parts:
                        edges.append(boundary_edges(core_p[r].select(d, 0),
                                                    theirs[j]))
        if merging:                              # 7
            more, infer.last_merge_dropped = _merge_edges(
                list(parts.values()), keys, edges, cap, mesh.size, pp,
                sizes + shape[len(axes):], plain)
            edges += more
        # 8: global union, size filter, dense numbering
        return packed_compact_labels(list(core_p.values()), keys,
                                     [t["count"] for t in parts.values()],
                                     edges, cap, mesh.size,
                                     min_size=pp.min_size)

    infer.cap, infer.max_pairs = cap, pp.merge_max_pairs
    infer.last_overflow = infer.last_merge_dropped = None
    return infer


def report_sharded_counts(infer) -> None:
    """Print what the last call of a ``make_sharded_infer_fn`` function
    kept on the card, in the reference's words: the label-table overflow
    and the saddle merge's dropped pairs. A host read, for after the
    labels; counts on the CPU were printed when they were made."""
    print_overflow(infer.last_overflow, infer.cap, SHARD_OVERFLOW)
    report_dropped(infer.last_merge_dropped, infer.max_pairs)


def shard_volume(volume, mesh: Mesh) -> list:
    """This process's per-shard slabs of a (D, H, W) volume (every shard's
    without a process group), each uploaded to its shard's device in the
    volume's dtype (``multihost.put_global``). Each slab is read on its
    own, so an ``np.memmap`` is never read whole."""
    D, H = volume.shape[:2]
    nz = mesh.shape[mesh.axis_names[0]]
    ny = mesh.shape[mesh.axis_names[1]] if len(mesh.axis_names) == 2 else 1
    if D % nz or H % ny:
        raise ValueError(f"volume {tuple(volume.shape)} does not split over "
                         f"the mesh {dict(mesh.shape)}")
    return put_global(volume, mesh)


def unshard(labels, mesh: Mesh) -> np.ndarray:
    """The shards' core labels as one numpy (D, H, W) array (the
    counterpart of ``np.asarray`` of a sharded ``jax.Array``). Under a
    process group ``labels`` are this process's shards' and every process
    gets the whole volume (one ``all_gather``)."""
    if is_distributed():
        labels = list(all_gather([torch.stack(labels)]).unbind(0))
    dl, hl, W = labels[0].shape
    nz = mesh.shape[mesh.axis_names[0]]
    ny = mesh.shape[mesh.axis_names[1]] if len(mesh.axis_names) == 2 else 1
    out = np.empty((nz * dl, ny * hl, W), np.int32)
    for r, lab in enumerate(labels):
        iz, iy = (mesh.coords(r) + (0,))[:2]
        out[iz * dl:(iz + 1) * dl, iy * hl:(iy + 1) * hl] = lab.cpu().numpy()
    return out
