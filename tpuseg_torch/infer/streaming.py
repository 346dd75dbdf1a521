"""Host-streamed whole-volume inference (port of ``tpuseg/infer/streaming.py``):
volumes larger than the card's memory, or than the 2^31 voxels that int32
labels can index, go through the device in z-chunks with ``halo`` planes
of context; with a 1-axis ``mesh`` each chunk is split over y across its
shards (the streamed x sharded composition, ``_make_sharded_chunk_fns``),
with the single-device chunk's outputs.

pass 1:  one host pass over the source: min/max and every
         ``normalize_sample_stride``-th x voxel, binned into the global
         percentile histogram (the same scalars for every chunk, bit for bit
         the one-shot path's);
pass 1b: (``postproc.fg_target_fraction > 0``) a net-only sweep builds the
         global foreground-probability histogram over the chunk cores, so
         the volume-matched threshold sees what the one-shot path sees;
pass 2:  each extended chunk runs the net sweep and the watershed (K1-K3,
         K5 under ``nms_impl="pallas"``, K4 under ``apply_impl="fused"``).
         Labels stay LOCAL int32 ``lin + 1`` over the extended chunk; only
         the small artifacts (the overlap plane, the first plane's edges,
         the ids and counts, the saddle-merge edges) are lifted to global
         int64 ids on the host by adding ``(z0 - halo) * H * W``. The lift
         keeps order, so the final ascending compaction equals the
         one-shot's.
finalize: a host union-find over the overlap-plane and merge edges, global
         sizes, the ``min_size`` filter and 1..K compaction, applied chunk by
         chunk in place.

Host memory: one int32 (D, H, W) result plus chunk-sized buffers. Device
memory follows the chunk, not the volume. Under a process group the mesh's
y-shards are spread over the processes: each reads the chunk's rows of its
own shards and uploads only those, the chunk's outputs are gathered to every
process, and the host passes and the finalize run identically in each (with
``resume_dir``, one directory per process). The labels equal the one-shot
``make_infer_fn``'s elementwise wherever instances fit within the halo.

PyTorch runs eagerly: there is no compiled chunk program and no staged
split. The watershed reads convergence flags on the host inside every
chunk, so two chunks' kernels cannot overlap; with ``overlap=True`` on a
card, the next chunk's upload (a pinned buffer and a copy stream) runs
under the current chunk's compute, and the previous chunk's host ingestion
runs while the current chunk's core copies back.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.core import Config
from tpuseg_torch.infer.pipeline import (block_logits, make_apply_fn,
                                         norm_scalars, watershed_labels)
from tpuseg_torch.ops.calibrate import (sampled_fg_counts,
                                        threshold_from_counts)
from tpuseg_torch.ops.components import rename, union_closure
from tpuseg_torch.ops.merge import (SENT, report_dropped,
                                    saddle_merge_core_edges,
                                    saddle_merge_edges)
from tpuseg_torch.ops.watershed import flood_truncation_count, threshold_mask
from tpuseg_torch.parallel.collectives import (all_gather, pmax, pmin,
                                               ppermute, psum)
from tpuseg_torch.parallel.halo import exchange_halo
from tpuseg_torch.parallel.mesh import replicas
from tpuseg_torch.parallel.multihost import is_distributed, is_multiprocess
from tpuseg_torch.parallel.reconcile import (CHUNK_OVERFLOW, boundary_edges,
                                             build_local_table, coord_labels,
                                             global_lin, packed_groups,
                                             print_overflow, rename_to_packed,
                                             report_overflow)


def _chunk_histogram(vol_chunk: np.ndarray, lo: float, span: float, bins: int):
    idx = np.clip(((vol_chunk.astype(np.float32) - lo) / span * bins), 0,
                  bins - 1).astype(np.int64)
    return np.bincount(idx.ravel(), minlength=bins)


def _read_ext(volume, z0, z1, halo, ext_z, D, rows=None):
    """Extended chunk ``[z0 - halo, z1 + halo)`` in the source dtype, clipped
    and edge-replicated at the volume's ends and padded up to ``ext_z``
    planes (the top padding fixes the origin local ids count from); only
    the y range ``rows`` of it where given. Returns ``(ext, mask_top,
    mask_bot)``: the fake planes at each end."""
    lo_z, hi_z = z0 - halo, z1 + halo
    r0, r1 = max(lo_z, 0), min(hi_z, D)
    ext = np.asarray(volume[r0:r1] if rows is None
                     else volume[r0:r1, rows[0]:rows[1]])
    pad_top, pad_bot = r0 - lo_z, hi_z - r1
    pad_static = ext_z - (pad_top + ext.shape[0] + pad_bot)
    if pad_top or pad_bot or pad_static:
        ext = np.pad(ext, ((pad_top, pad_bot + pad_static), (0, 0), (0, 0)),
                     mode="edge")
    return ext, pad_top, pad_bot + pad_static


def _mask_fake(prob: torch.Tensor, mask_top: int, mask_bot: int):
    """Zero the fake (edge-replicated) planes at the volume's ends."""
    prob[:mask_top] = 0.0
    prob[prob.shape[0] - mask_bot:] = 0.0
    return prob


def _chunk_probs(apply_fn, ext, lo, hi, mask_top, mask_bot, cfg: Config):
    """Normalized net sweep of an extended chunk (or of its y-slab; the
    normalization runs per tile block, equal elementwise to normalizing
    first) -> (fg, peak) float32 probabilities with the fake z planes
    zeroed."""
    out = block_logits(apply_fn, ext, norm_scalars(lo, hi), cfg,
                       cfg.infer.halo)
    fg = torch.sigmoid(out["fg_logits"].float())
    pk = torch.sigmoid(out["peak_logits"].float())
    return _mask_fake(fg, mask_top, mask_bot), _mask_fake(pk, mask_top,
                                                          mask_bot)


def _make_chunk_fns(model, cfg: Config, halo: int, chunk_z: int,
                    calib_bins: int = 4096):
    """``(fg_hist_fn, chunk_net_fn, chunk_post_fn)``: the per-chunk device
    work of passes 1b and 2."""
    apply_fn = make_apply_fn(model, cfg)
    pp = cfg.postproc

    def chunk_net_fn(ext, lo, hi, mask_top, mask_bot):
        return _chunk_probs(apply_fn, ext, lo, hi, mask_top, mask_bot, cfg)

    def fg_hist_fn(ext, lo, hi, mask_top, mask_bot):
        """``(counts, n)``: the core's fg histogram and its sample count.
        Fake planes inside a short last chunk's core land in bin 0; the
        caller subtracts them."""
        fg, _ = chunk_net_fn(ext, lo, hi, mask_top, mask_bot)
        return sampled_fg_counts(fg[halo:halo + chunk_z],
                                 cfg.data.normalize_sample_stride, calib_bins)

    def chunk_post_fn(fg, pk, fg_thr, cz):
        """Watershed of the extended chunk, cropped on the device: int32
        local labels of the ``cz`` real core planes, the overlap plane, the
        passing saddle-merge edges, the flood-truncation count over the
        extended window, and the core's label ids and voxel counts."""
        labels = watershed_labels(fg, pk, pp, fg_thr)
        if pp.merge_saddle_ratio > 0:
            # only the passing edges leave the device: the host union-find
            # that joins chunk-boundary ids applies them
            me_lo, me_hi, dropped = saddle_merge_edges(
                labels, pk, pp.merge_saddle_ratio,
                max_pairs=pp.merge_max_pairs)
            me_lo, me_hi = _passing(me_lo, me_hi, dropped, pp)
        else:
            me_lo = me_hi = torch.zeros(0, dtype=torch.int32)
        # an upper bound over overlapping windows; zero stays exact
        n_trunc = int(flood_truncation_count(labels,
                                             threshold_mask(fg, fg_thr)))
        return _crop_chunk(labels, halo, chunk_z, cz) + (me_lo, me_hi,
                                                         n_trunc)

    return fg_hist_fn, chunk_net_fn, chunk_post_fn


def _passing(me_lo, me_hi, dropped, pp):
    """The passing edges out of the fixed-size slots, with the dropped
    pairs reported: host reads, between chunks."""
    report_dropped(dropped, pp.merge_max_pairs)
    keep = me_lo != SENT
    return me_lo[keep], me_hi[keep]


def _crop_chunk(labels, halo: int, chunk_z: int, cz: int):
    """``(core, overlap, ids, counts)`` of an extended chunk's labels: the
    ``cz`` real core planes, the overlap plane (the next chunk's first;
    ``None`` without a halo), and the core's label ids and voxel
    counts."""
    core = labels[halo:halo + cz]
    overlap = labels[halo + chunk_z] if halo > 0 else None
    ids, counts = torch.unique(core[core > 0], return_counts=True)
    return core, overlap, ids, counts


def _make_sharded_chunk_fns(model, cfg: Config, halo: int, chunk_z: int,
                            mesh, calib_bins: int = 4096):
    """The chunk functions of ``_make_chunk_fns`` with each extended chunk
    split over y across a 1-axis mesh (the streamed x sharded
    composition), with the single-device chunk's outputs: every y-shard
    takes ``infer.shard_halo`` planes of its neighbours' rows, sweeps the
    net, zeroes its fake y halo, runs the watershed, and builds its bounded
    table of its core rows' and overlap plane's ids; one packed closure
    over the y boundaries renames every instance to its smallest root
    coordinate in the chunk (``packed_groups``, ``coord_labels``): the
    single-device chunk's local ids, so the host's z reconciliation does
    not see the mesh. As the single-device chunk does, the chunk sends its
    saddle-merge edges to the host union-find instead of merging on the
    device: each shard tests the faces of its core rows on the reconciled
    labels, a group's maximum being the peak at its root, read by the
    shard whose table holds the root (``saddle_merge_core_edges``); the
    edges are the single-device chunk's wherever its labels are. (The JAX
    package merges each y-slab on its device before the reconciliation;
    the two agree for instances and merge chains within the halos.)

    Under a process group each process holds the y-slabs of its own shards
    (``ext`` holds only their rows) and the chunk's outputs — labels, merge
    edges, truncation count — are gathered to every process."""
    if len(mesh.axis_names) != 1:
        raise ValueError("stream_infer(mesh=...) shards each chunk over y: "
                         f"the mesh needs one axis, got {mesh.axis_names}")
    n_y = mesh.size
    halo_y = cfg.infer.shard_halo
    cap = cfg.infer.shard_max_labels
    pp = cfg.postproc
    local = mesh.local_ranks()
    apply_fns = {d: make_apply_fn(m, cfg) for d, m in replicas(
        model, [mesh.devices[i] for i in local]).items()}
    gathered = is_distributed()

    def chunk_net_fn(ext, lo, hi, mask_top, mask_bot):
        """Per y-shard (fg, peak) lists on the y-extended slabs (``None`` for
        another process's shard), the fake z planes and the fake
        (edge-replicated) y halos zeroed: those voxels are not in the
        single-device chunk's watershed domain."""
        hl = ext.shape[1] // len(local)
        slabs = [None] * n_y
        for j, i in enumerate(local):
            slabs[i] = ext[:, j * hl:(j + 1) * hl].to(mesh.devices[i]).float()
        slabs = exchange_halo(slabs, halo_y, dim=1, owners=mesh.processes)
        fg, pk = [None] * n_y, [None] * n_y
        for i in local:
            slab = slabs[i]
            d = slab.device
            f, p = _chunk_probs(apply_fns[d], slab, lo.to(d), hi.to(d),
                                mask_top, mask_bot, cfg)
            slabs[i] = None
            for t in (f, p):
                if i == 0:
                    t[:, :halo_y] = 0.0
                if i == n_y - 1:
                    t[:, halo_y + hl:] = 0.0
            fg[i], pk[i] = f, p
        return fg, pk

    def fg_hist_fn(ext, lo, hi, mask_top, mask_bot):
        fg, _ = chunk_net_fn(ext, lo, hi, mask_top, mask_bot)
        hl = ext.shape[1] // len(local)
        parts = [sampled_fg_counts(
            fg[i][halo:halo + chunk_z, halo_y:halo_y + hl],
            cfg.data.normalize_sample_stride, calib_bins) for i in local]
        # every y-shard's core is the same size
        return psum([h for h, _ in parts]), parts[0][1] * mesh.size

    def chunk_post_fn(fg, pk, fg_thr, cz):
        ez, hly, W = fg[local[0]].shape
        hl = hly - 2 * halo_y
        H = hl * n_y
        dev = mesh.devices[local[0]]
        merging = pp.merge_saddle_ratio > 0
        grown_p = [None] * n_y
        grown_pk, tables, peaks, n_distinct = [], [], [], []
        n_trunc = 0
        for i in local:
            lab = watershed_labels(fg[i], pk[i], pp, fg_thr)
            n_trunc += int(flood_truncation_count(
                lab, threshold_mask(fg[i], fg_thr)))
            fg[i] = None
            # the full extended z range (the chunk's crops come after): the
            # core rows and the overlap row, the next shard's first
            grown = lab[:, halo_y:halo_y + hl + (n_y > 1)]
            table, _, nd = build_local_table(
                grown[:, :hl], [grown[:, hl]] if n_y > 1 else [], cap)
            tables.append(table)
            n_distinct.append(nd)
            grown_p[i] = rename_to_packed(grown, table, i, cap)
            if merging:                   # an unused slot reads any voxel
                peaks.append(pk[i].reshape(-1)[(table.long() - 1).clamp_(
                    0, pk[i].numel() - 1)])
                grown_pk.append(pk[i][:, halo_y:halo_y + grown.shape[1]])
            pk[i] = None
        # between chunks the host reads: the overflow prints at once
        print_overflow(report_overflow(n_distinct, cap, CHUNK_OVERFLOW), cap,
                       CHUNK_OVERFLOW)
        if ez * H * W > 2 ** 31 - 1:      # the chunk's coordinate labels
            raise ValueError("coordinate labels exceed the int32 range: "
                             f"an extended chunk of {ez * H * W} voxels")
        keys = [global_lin(t, hly, (0, i * hl - halo_y), H, W)
                for i, t in zip(local, tables)]
        edges = []
        if n_y > 1:
            theirs = ppermute([None if p is None else p[:, hl]
                               for p in grown_p],
                              [(j, j + 1) for j in range(n_y - 1)],
                              mesh.processes)
            edges = [boundary_edges(grown_p[j][:, 0], theirs[j])
                     for j in local]
        # every group renamed to its smallest root coordinate in the chunk
        group, gmin, gval = packed_groups(keys, edges, cap, n_y,
                                          peaks if merging else None)
        coord = coord_labels(gmin).to(dev)
        group = group.to(dev)
        parts = [group[grown_p[i].to(dev).long()] for i in local]
        labels = torch.cat([coord[p[:, :hl].long()] for p in parts], dim=1)
        me_lo = me_hi = torch.zeros(0, dtype=torch.int32, device=dev)
        if merging:
            # as the single-device chunk, the passing edges go to the host
            # union-find; each shard tests the faces of its core rows
            e = [saddle_merge_core_edges(
                p, q.to(dev), (p.shape[0], hl, W), pp.merge_saddle_ratio,
                gval.to(dev), max_pairs=pp.merge_max_pairs)
                for p, q in zip(parts, grown_pk)]
            me_lo, me_hi = (torch.cat([torch.where(
                x[k] != SENT, coord[x[k].long().clamp(max=coord.numel() - 1)],
                SENT) for x in e]) for k in (0, 1))
            dropped = pmax([x[2] for x in e])
        if gathered:
            # every process gets the whole chunk: its rows, by shard
            labels = all_gather([labels.movedim(1, 0)]).movedim(0, 1)
            me_lo, me_hi = all_gather([me_lo]), all_gather([me_hi])
            n_trunc = int(psum([torch.tensor(n_trunc)]))
        if merging:
            me_lo, me_hi = _passing(me_lo, me_hi, dropped, pp)
        return _crop_chunk(labels, halo, chunk_z, cz) + (me_lo, me_hi,
                                                         n_trunc)

    return fg_hist_fn, chunk_net_fn, chunk_post_fn


class _Uploader:
    """Puts extended chunks on the device. With ``overlap`` (a card only),
    the next chunk is staged through one pinned host buffer and copied on a
    side stream, so its upload runs under the current chunk's kernels."""

    def __init__(self, volume, chunks, halo, ext_z, device, overlap,
                 rows=None):
        self.volume, self.chunks, self.halo, self.ext_z = (
            volume, chunks, halo, ext_z)
        self.rows = rows                 # a y range of the chunk, or all
        self.D = volume.shape[0]
        self.device = device
        self.overlap = overlap and device.type == "cuda"
        if self.overlap:
            self.stream = torch.cuda.Stream(device)
            self.pinned = None
            self.done = None             # the last copy out of ``pinned``

    def __call__(self, ci):
        z0, z1 = self.chunks[ci]
        ext, mt, mb = _read_ext(self.volume, z0, z1, self.halo, self.ext_z,
                                self.D, self.rows)
        if not self.overlap:
            if not ext.flags.writeable:  # a view of a read-only memmap
                ext = ext.copy()
            return torch.from_numpy(ext).to(self.device), mt, mb, None
        if self.pinned is None:
            dtype = torch.from_numpy(np.empty(0, ext.dtype)).dtype
            self.pinned = torch.empty(ext.shape, dtype=dtype, pin_memory=True)
        if self.done is not None:
            self.done.synchronize()
        self.pinned.numpy()[...] = ext
        with torch.cuda.stream(self.stream):
            dev = self.pinned.to(self.device, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(self.stream)
        return dev, mt, mb, self.done

    def ready(self, staged):
        """The staged chunk's device tensor, safe to use on the current
        stream."""
        dev, mt, mb, event = staged
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            dev.record_stream(torch.cuda.current_stream(self.device))
        return dev, mt, mb


def _percentile_scalars(volume, chunks, cfg: Config, bins: int,
                        sample_cache_bytes: int):
    """Pass 1: the global percentile scalars from ONE host pass over the
    source. The strided sample (source dtype) stays in memory, or is spilled
    to a temporary directory beyond ``sample_cache_bytes``; the histogram is
    then binned from it with the one-shot path's float32 arithmetic."""
    D, H, W = volume.shape
    stride = max(cfg.data.normalize_sample_stride, 1)
    itemsize = np.dtype(volume.dtype).itemsize if hasattr(volume, "dtype") \
        else 4
    est_bytes = D * H * len(range(0, W, stride)) * itemsize
    spill_dir = (tempfile.mkdtemp(prefix="tpuseg_torch_normcache_")
                 if est_bytes > sample_cache_bytes else None)
    try:
        samples = []
        gmin, gmax = np.inf, -np.inf
        for i, (z0, z1) in enumerate(chunks):
            c = np.asarray(volume[z0:z1])
            cf = c if c.dtype == np.float32 else c.astype(np.float32)
            gmin = min(gmin, float(cf.min()))
            gmax = max(gmax, float(cf.max()))
            s = np.ascontiguousarray(c[..., ::stride])
            if spill_dir is not None:
                np.save(os.path.join(spill_dir, f"s{i:06d}.npy"), s)
                s = None
            samples.append(s)
        span = max(gmax - gmin, 1e-12)
        hist = np.zeros(bins, np.int64)
        n_sampled = 0
        for i, s in enumerate(samples):
            if s is None:
                s = np.load(os.path.join(spill_dir, f"s{i:06d}.npy"))
            hist += _chunk_histogram(s, gmin, span, bins)
            n_sampled += s.size
    finally:
        if spill_dir is not None:
            shutil.rmtree(spill_dir, ignore_errors=True)
    cdf = np.cumsum(hist.astype(np.float32) / np.float32(n_sampled))

    def pct(p):
        b = np.searchsorted(cdf, np.float32(p / 100.0))
        return np.float32(gmin) + (np.float32(b) + np.float32(0.5)) \
            / np.float32(bins) * np.float32(span)

    return pct(cfg.data.normalize_pcts[0]), pct(cfg.data.normalize_pcts[1])


def stream_infer(
    model,
    cfg: Config,
    volume,                      # array-like: volume[z0:z1] -> numpy
    out=None,                    # optional preallocated int32 (D, H, W) sink
    chunk_z: int = 64,
    halo: Optional[int] = None,
    normalize: bool = True,
    bins: int = 4096,
    sample_cache_bytes: int = 8 << 30,
    stats: Optional[dict] = None,
    mesh=None,
    resume_dir: Optional[str] = None,
    on_chunk_done=None,          # called with ci after each chunk is ingested
    device="cuda",
    overlap: bool = True,
) -> np.ndarray:
    """Stream ``volume`` through ``device`` in z-chunks; returns (or fills
    ``out`` with) the dense int32 instance labels 1..K. ``model`` maps
    (B, 1, d, h, w) blocks to ``{"fg_logits", "peak_logits"}`` and must sit
    on ``device``. ``halo`` defaults to ``cfg.infer.shard_halo``.

    ``resume_dir``: per-chunk progress checkpoints (``meta.json`` with the
    geometry and the normalization and threshold scalars, ``chunk_*.npz``
    with each finished chunk's artifacts and flood-truncation count,
    ``finalize.json`` and ``lift_backup.npz`` for a kill during the final
    lift). A killed run restarted with the same arguments and the same
    persistent ``out`` (e.g. an ``np.memmap``, which holds the finished core
    labels) resumes from the first unfinished chunk; another geometry
    empties the directory and starts over.

    ``stats``: filled with stage seconds (``t_normalize_pass``,
    ``t_calibrate_pass``, ``t_chunks``, ``t_finalize``), the summed
    ``flood_truncated_voxels`` (resumed chunks included), ``fg_threshold``
    (pass 1b's volume-matched threshold, or the configured one) and, on a
    card, ``peak_device_bytes``: the peak allocation from the call's start
    to the end of pass 2 (the call resets the device's peak counter, so it
    counts what the caller still holds, such as the model, and nothing the
    caller freed before).

    ``mesh``: a 1-axis ``parallel.Mesh``; each extended chunk is then split
    over y across its shards (``infer.shard_halo`` rows of context each
    side, ``H`` a multiple of the shard count) and the result equals the
    single-device stream's for instances within the halos. The chunk
    goes to the first local shard's device and its y-slabs to theirs;
    ``device`` is not used. Under a process group every process calls
    ``stream_infer`` with the same arguments (``resume_dir`` and ``out``
    its own) and reads, uploads and computes only its own shards' rows;
    several processes need a mesh.

    ``overlap=False`` runs the chunks' copies in sequence with their compute
    (the version ``chip_smoke.py`` times the overlapped one against); on a
    CPU device they always are.
    """
    if mesh is None and is_multiprocess():
        raise ValueError("a multi-process stream needs a mesh: pass "
                         "stream_infer(mesh=...) over the processes' shards")
    if mesh is not None:
        local = mesh.local_ranks()
        device = mesh.devices[local[0]]
    device = torch.device(device)
    cards = ({mesh.devices[i] for i in local if mesh.devices[i].type == "cuda"}
             if mesh is not None
             else {device} if device.type == "cuda" else set())
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    marks = {}

    def mark(key):
        now = time.perf_counter()
        if marks:
            k0, t0 = marks.popitem()
            if stats is not None:
                stats[k0] = stats.get(k0, 0.0) + (now - t0)
        marks[key] = now

    mark("t_normalize_pass")
    D, H, W = volume.shape
    halo = cfg.infer.shard_halo if halo is None else halo
    chunks = [(z, min(z + chunk_z, D)) for z in range(0, D, chunk_z)]
    plane = H * W
    ext_z = chunk_z + 2 * halo
    if ext_z * plane >= 2 ** 31:
        raise ValueError(
            f"extended chunk ({ext_z}, {H}, {W}) exceeds the int32 "
            "linear-index range of chunk labels; lower chunk_z or halo")

    geom = dict(D=D, H=H, W=W, chunk_z=chunk_z, halo=halo, bins=bins,
                sharded=int(mesh is not None))
    resume_meta = None
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
        meta_path = os.path.join(resume_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                m = json.load(f)
            if m.get("geom") == geom:
                resume_meta = m
            else:
                for fn in os.listdir(resume_dir):
                    os.remove(os.path.join(resume_dir, fn))
        if is_distributed() and int(pmin([torch.tensor(
                int(resume_meta is not None))])) == 0:
            # the processes resume together or start over together
            resume_meta = None
            for fn in os.listdir(resume_dir):
                os.remove(os.path.join(resume_dir, fn))

    # ---- pass 1: global percentile scalars ----
    if resume_meta is not None:
        lo, hi = np.float32(resume_meta["lo"]), np.float32(resume_meta["hi"])
    elif normalize:
        lo, hi = _percentile_scalars(volume, chunks, cfg, bins,
                                     sample_cache_bytes)
    else:
        lo, hi = np.float32(0.0), np.float32(1.0)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    if mesh is None:
        fg_hist_fn, chunk_net_fn, chunk_post_fn = _make_chunk_fns(
            model, cfg, halo, chunk_z, bins)
    else:
        if H % mesh.size:
            raise ValueError(f"volume H={H} must divide the mesh's "
                             f"{mesh.size} y-shards")
        fg_hist_fn, chunk_net_fn, chunk_post_fn = _make_sharded_chunk_fns(
            model, cfg, halo, chunk_z, mesh, bins)
    rows = None
    if mesh is not None and len(local) < mesh.size:
        hl = H // mesh.size
        rows = (local[0] * hl, (local[-1] + 1) * hl)
    upload = _Uploader(volume, chunks, halo, ext_z, device, overlap, rows)
    mark("t_calibrate_pass")

    # ---- pass 1b: volume-matched fg threshold (an extra net pass) ----
    with torch.inference_mode():
        if resume_meta is not None:
            fg_thr = resume_meta["fg_thr"]
        elif cfg.postproc.fg_target_fraction > 0:
            fg_hist = np.zeros(bins, np.int64)
            n_core = 0
            staged = upload(0)
            for ci, (z0, z1) in enumerate(chunks):
                ext, mt, mb = upload.ready(staged)
                h, n = fg_hist_fn(ext, lo_t, hi_t, mt, mb)
                if ci + 1 < len(chunks):
                    staged = upload(ci + 1)
                h = h.cpu().numpy().astype(np.int64)
                # fake planes inside a short last chunk's core: prob 0.0
                fake_core = max(0, (z0 + chunk_z) - D) * (n // chunk_z)
                h[0] -= fake_core
                fg_hist += h
                n_core += n - fake_core
            fg_thr = float(threshold_from_counts(
                torch.from_numpy(fg_hist), n_core,
                cfg.postproc.fg_target_fraction))
        else:
            fg_thr = cfg.postproc.fg_threshold
    if stats is not None:
        stats["fg_threshold"] = float(fg_thr)

    if resume_dir is not None and resume_meta is None:
        with open(meta_path + ".tmp", "w") as f:
            json.dump({"geom": geom, "lo": float(lo), "hi": float(hi),
                       "fg_thr": float(fg_thr)}, f)
        os.replace(meta_path + ".tmp", meta_path)

    mark("t_chunks")
    # ---- pass 2: chunked net + watershed, host reconciliation ----
    result = out if out is not None else np.zeros((D, H, W), np.int32)
    edge_chunks = []                  # (E_i, 2) int64 global-id edges
    id_chunks, count_chunks = [], []  # per-chunk global ids and voxel counts
    state = {"prev_overlap": None}    # the previous chunk's copy of our plane 0
    n_trunc_total = 0

    fin_path = (os.path.join(resume_dir, "finalize.json")
                if resume_dir is not None else None)
    fin_done_upto = 0
    start_ci = 0

    def chunk_path(ci):
        return os.path.join(resume_dir, f"chunk_{ci:06d}.npz")

    if resume_meta is not None:
        fin = {}
        if os.path.exists(fin_path):
            with open(fin_path) as f:
                fin = json.load(f)
        if is_distributed():
            done = torch.tensor(int(bool(fin.get("complete"))))
            if int(pmin([done])) != int(pmax([done])):
                raise ValueError(f"{resume_dir}: the processes' resume "
                                 "directories disagree on a finished stream")
        if fin.get("complete"):
            # the previous run finished: ``result`` holds the final labels
            if stats is not None:
                stats["resumed_complete"] = True
            return result
        fin_done_upto = int(fin.get("done_upto", 0))
        while os.path.exists(chunk_path(start_ci)):
            start_ci += 1
        if is_distributed():
            # the chunks every process finished: the collectives stay in step
            start_ci = int(pmin([torch.tensor(start_ci)]))
            fin_done_upto = min(fin_done_upto, start_ci)
        for ci in range(start_ci):
            a = np.load(chunk_path(ci))
            id_chunks.append(a["ids"])
            count_chunks.append(a["counts"])
            n_trunc_total += int(a["n_trunc"])
            if a["edges"].size:
                edge_chunks.append(a["edges"])
            if ci == start_ci - 1 and bool(a["has_overlap"]):
                off = np.int64(chunks[ci][0] - halo) * plane
                ov = a["overlap"]
                state["prev_overlap"] = np.where(
                    ov > 0, ov.astype(np.int64) + off, 0)

    def ingest(ci, core, nxt, me_lo, me_hi, n_trunc, ids, counts):
        """Host side of chunk ``ci``: its core labels into ``result``, its
        artifacts lifted to global ids."""
        z0, z1 = chunks[ci]
        offset = np.int64(z0 - halo) * plane
        result[z0:z1] = core                     # local ids, lifted at finalize
        core0 = np.where(core[0] > 0, core[0].astype(np.int64) + offset, 0)
        edges_ci = np.zeros((0, 2), np.int64)
        prev = state["prev_overlap"]
        if prev is not None:
            both = (core0 > 0) & (prev > 0) & (core0 != prev)
            if both.any():
                edges_ci = np.stack([core0[both], prev[both]], axis=-1)
        if me_lo.size:
            ge = np.stack([me_lo.astype(np.int64) + offset,
                           me_hi.astype(np.int64) + offset], axis=-1)
            edges_ci = np.concatenate([edges_ci, ge])
        if edges_ci.size:
            edge_chunks.append(edges_ci)
        state["prev_overlap"] = (
            np.where(nxt > 0, nxt.astype(np.int64) + offset, 0)
            if nxt is not None else None)
        id_chunks.append(ids.astype(np.int64) + offset)
        count_chunks.append(counts.astype(np.int64))
        if resume_dir is not None:
            tmp = chunk_path(ci) + ".tmp.npz"
            np.savez_compressed(
                tmp, ids=id_chunks[-1], counts=count_chunks[-1],
                edges=edges_ci, n_trunc=np.int64(n_trunc),
                overlap=(nxt if nxt is not None
                         else np.zeros((0, 0), np.int32)),
                has_overlap=np.bool_(nxt is not None))
            os.replace(tmp, chunk_path(ci))
        if on_chunk_done is not None:
            on_chunk_done(ci)

    pinned = None
    if upload.overlap and start_ci < len(chunks):
        # two sets of core buffers: chunk N copies back into one while
        # chunk N-1 is ingested from the other
        pinned = [torch.empty((chunk_z, H, W), dtype=torch.int32,
                              pin_memory=True) for _ in range(2)]
    pending = None
    with torch.inference_mode():
        staged = upload(start_ci) if start_ci < len(chunks) else None
        for ci in range(start_ci, len(chunks)):
            z0, z1 = chunks[ci]
            cz = z1 - z0
            ext, mt, mb = upload.ready(staged)
            fg, pk = chunk_net_fn(ext, lo_t, hi_t, mt, mb)
            del ext
            if ci + 1 < len(chunks):
                staged = upload(ci + 1)   # copies under this chunk's kernels
            core, overlap_plane, ids, counts, me_lo, me_hi, n_trunc = \
                chunk_post_fn(fg, pk, fg_thr, cz)
            del fg, pk
            n_trunc_total += n_trunc
            small = (overlap_plane.cpu().numpy()
                     if overlap_plane is not None and z1 < D else None,
                     me_lo.cpu().numpy(), me_hi.cpu().numpy(), n_trunc,
                     ids.cpu().numpy(), counts.cpu().numpy())
            if pinned is None:
                host_core = core.cpu().numpy()
                ingest(ci, host_core, *small)
                continue
            buf = pinned[ci % 2][:cz]
            buf.copy_(core, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            if pending is not None:
                ingest(*pending)
            copied.synchronize()
            pending = (ci, buf.numpy(), *small)
        if pending is not None:
            ingest(*pending)
    if stats is not None:
        if n_trunc_total:
            stats["flood_truncated_voxels"] = n_trunc_total
        if cards:
            stats["peak_device_bytes"] = max(
                torch.cuda.max_memory_allocated(d) for d in cards)

    mark("t_finalize")
    # ---- finalize: union roots, global size filter, dense compaction ----
    edges = (np.concatenate(edge_chunks) if edge_chunks
             else np.zeros((0, 2), np.int64))
    table = union_closure(edges)
    all_ids = np.concatenate(id_chunks) if id_chunks else np.zeros(0, np.int64)
    all_counts = (np.concatenate(count_chunks) if count_chunks
                  else np.zeros(0, np.int64))

    roots = rename(all_ids, *table)
    uniq_roots, inv = np.unique(roots, return_inverse=True)
    root_sizes = np.zeros(len(uniq_roots), np.int64)
    np.add.at(root_sizes, inv, all_counts)
    kept = root_sizes >= cfg.postproc.min_size
    rank_of_root = np.where(kept, np.cumsum(kept), 0)   # dense 1..K
    # global id -> dense rank of its (kept) root
    sort_ids = np.unique(all_ids)
    id_rank = rank_of_root[
        np.searchsorted(uniq_roots, rename(sort_ids, *table))].astype(np.int32)

    def write_fin(payload):
        if fin_path is not None:
            with open(fin_path + ".tmp", "w") as f:
                json.dump(payload, f)
            os.replace(fin_path + ".tmp", fin_path)

    # a kill during the lift leaves one chunk neither raw nor final: it is
    # restored from the one-chunk raw backup
    bk_path = (os.path.join(resume_dir, "lift_backup.npz")
               if resume_dir is not None else None)
    if bk_path is not None and os.path.exists(bk_path):
        bk = np.load(bk_path)
        ci_bk = int(bk["ci"])
        if fin_done_upto <= ci_bk < len(chunks):
            z0b, z1b = chunks[ci_bk]
            result[z0b:z1b] = bk["core"]

    # in-place lift + rename, chunk by chunk, foreground voxels only
    for ci, (z0, z1) in enumerate(chunks):
        if ci < fin_done_upto:
            continue                    # lifted before the interruption
        core = result[z0:z1]
        if bk_path is not None:
            np.savez_compressed(bk_path + ".tmp.npz", ci=ci, core=core)
            os.replace(bk_path + ".tmp.npz", bk_path)
        if len(sort_ids):
            fgm = core > 0
            vals = core[fgm].astype(np.int64) + np.int64(z0 - halo) * plane
            pos = np.clip(np.searchsorted(sort_ids, vals), 0,
                          len(sort_ids) - 1)
            renamed = np.where(sort_ids[pos] == vals, id_rank[pos],
                               0).astype(np.int32)
            out_chunk = np.zeros_like(core)
            out_chunk[fgm] = renamed
            result[z0:z1] = out_chunk
        else:
            result[z0:z1] = 0
        write_fin({"done_upto": ci + 1})
    if bk_path is not None and os.path.exists(bk_path):
        os.remove(bk_path)
    write_fin({"complete": True})
    mark("end")
    return result
