"""Host-streamed whole-volume inference (port of ``tpuseg/infer/streaming.py``,
single-device leg): volumes larger than the card's memory, or than the
2^31 voxels that int32 labels can index, go through the device in z-chunks
with ``halo`` planes of context.

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
memory follows the chunk, not the volume. The labels equal the one-shot
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
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.infer.pipeline import make_apply_fn
from tpuseg_torch.infer.tiles import tiled_forward
from tpuseg_torch.ops.components import rename, union_closure
from tpuseg_torch.ops.merge import saddle_merge_edges
from tpuseg_torch.ops.watershed import flood_truncation_count, watershed


def _chunk_histogram(vol_chunk: np.ndarray, lo: float, span: float, bins: int):
    idx = np.clip(((vol_chunk.astype(np.float32) - lo) / span * bins), 0,
                  bins - 1).astype(np.int64)
    return np.bincount(idx.ravel(), minlength=bins)


def _read_ext(volume, z0, z1, halo, ext_z, D):
    """Extended chunk ``[z0 - halo, z1 + halo)`` in the source dtype, clipped
    and edge-replicated at the volume's ends and padded up to ``ext_z``
    planes (the top padding fixes the origin local ids count from). Returns
    ``(ext, mask_top, mask_bot)``: the fake planes at each end."""
    lo_z, hi_z = z0 - halo, z1 + halo
    r0, r1 = max(lo_z, 0), min(hi_z, D)
    ext = np.asarray(volume[r0:r1])
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


def _make_chunk_fns(model, cfg: Config, halo: int, chunk_z: int,
                    calib_bins: int = 4096):
    """``(fg_hist_fn, chunk_net_fn, chunk_post_fn)``: the per-chunk device
    work of passes 1b and 2."""
    apply_fn = make_apply_fn(model, cfg)
    compute_dtype = resolve(cfg.infer.compute_dtype)
    pp = cfg.postproc

    def chunk_net_fn(ext, lo, hi, mask_top, mask_bot):
        """Normalized net sweep of the extended chunk (normalization per
        tile block, equal elementwise to normalizing first) -> (fg, peak)
        float32 probabilities with the fake planes zeroed."""
        span = torch.clamp(hi - lo, min=1e-6)

        def preprocess(b):
            return torch.clamp((b - lo) / span, 0.0, 1.0)

        out = tiled_forward(apply_fn, ext.float(), tile=cfg.infer.tile,
                            halo=cfg.infer.halo,
                            tile_batch=cfg.infer.tile_batch,
                            compute_dtype=compute_dtype, preprocess=preprocess)
        fg = torch.sigmoid(out["fg_logits"].float())
        pk = torch.sigmoid(out["peak_logits"].float())
        return _mask_fake(fg, mask_top, mask_bot), _mask_fake(pk, mask_top,
                                                              mask_bot)

    def fg_hist_fn(ext, lo, hi, mask_top, mask_bot):
        """int64 histogram of the core's fg probabilities over every
        ``normalize_sample_stride``-th x voxel (the voxels the one-shot
        calibration sees: cores partition the volume). Fake planes inside a
        short last chunk's core land in bin 0; the caller subtracts them."""
        fg, _ = chunk_net_fn(ext, lo, hi, mask_top, mask_bot)
        core = fg[halo:halo + chunk_z]
        stride = cfg.data.normalize_sample_stride
        if stride > 1:
            core = core[..., ::stride]
        idx = torch.clamp((core * calib_bins).to(torch.int32), 0,
                          calib_bins - 1)
        return torch.bincount(idx.reshape(-1).long(), minlength=calib_bins)

    def chunk_post_fn(fg, pk, fg_thr, cz):
        """Watershed of the extended chunk, cropped on the device: int32
        local labels of the ``cz`` real core planes, the overlap plane, the
        passing saddle-merge edges, the flood-truncation count over the
        extended window, and the core's label ids and voxel counts."""
        labels = watershed(fg, pk, peak_threshold=pp.peak_threshold,
                           fg_threshold=fg_thr, peak_radius=pp.nms_radius,
                           flood_iters=pp.flood_iters, method=pp.method,
                           nms_impl=pp.nms_impl, resolve_impl=pp.resolve_impl,
                           label_space="index")
        if pp.merge_saddle_ratio > 0:
            # only the passing edges leave the device: the host union-find
            # that joins chunk-boundary ids applies them
            me_lo, me_hi = saddle_merge_edges(labels, pk,
                                              pp.merge_saddle_ratio,
                                              max_pairs=pp.merge_max_pairs)
        else:
            me_lo = me_hi = torch.zeros(0, dtype=torch.int32)
        # an upper bound over overlapping windows; zero stays exact
        n_trunc = int(flood_truncation_count(labels, fg >= fg_thr))
        core = labels[halo:halo + cz]
        overlap = labels[halo + chunk_z] if halo > 0 else None
        ids, counts = torch.unique(core[core > 0], return_counts=True)
        return core, overlap, me_lo, me_hi, n_trunc, ids, counts

    return fg_hist_fn, chunk_net_fn, chunk_post_fn


class _Uploader:
    """Puts extended chunks on the device. With ``overlap`` (a card only),
    the next chunk is staged through one pinned host buffer and copied on a
    side stream, so its upload runs under the current chunk's kernels."""

    def __init__(self, volume, chunks, halo, ext_z, device, overlap):
        self.volume, self.chunks, self.halo, self.ext_z = (
            volume, chunks, halo, ext_z)
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
                                self.D)
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

    ``overlap=False`` runs the chunks' copies in sequence with their compute
    (the version ``chip_smoke.py`` times the overlapped one against); on a
    CPU device they always are. ``mesh`` (chunks sharded over several
    devices) is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError(
            "stream_infer(mesh=...) is not ported yet: the streamed x "
            "sharded composition waits for ROADMAP.md Queue 1 item 6 "
            "(sharded and multi-process inference)")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
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
                sharded=0)
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
    fg_hist_fn, chunk_net_fn, chunk_post_fn = _make_chunk_fns(
        model, cfg, halo, chunk_z, bins)
    upload = _Uploader(volume, chunks, halo, ext_z, device, overlap)
    mark("t_calibrate_pass")

    # ---- pass 1b: volume-matched fg threshold (an extra net pass) ----
    with torch.inference_mode():
        if resume_meta is not None:
            fg_thr = resume_meta["fg_thr"]
        elif cfg.postproc.fg_target_fraction > 0:
            stride = cfg.data.normalize_sample_stride
            sample_plane = H * len(range(0, W, max(stride, 1)))
            fg_hist = np.zeros(bins, np.int64)
            n_core = 0
            staged = upload(0)
            for ci, (z0, z1) in enumerate(chunks):
                ext, mt, mb = upload.ready(staged)
                h = fg_hist_fn(ext, lo_t, hi_t, mt, mb)
                if ci + 1 < len(chunks):
                    staged = upload(ci + 1)
                h = h.cpu().numpy().astype(np.int64)
                # fake planes inside a short last chunk's core: prob 0.0
                fake_core = max(0, (z0 + chunk_z) - D) * sample_plane
                h[0] -= fake_core
                fg_hist += h
                n_core += chunk_z * sample_plane - fake_core
            assert n_core == D * sample_plane
            # ops.calibrate.threshold_for_fraction's float32 arithmetic
            tail = (np.cumsum(fg_hist[::-1])[::-1].astype(np.float32)
                    / np.float32(n_core))
            b = int(np.sum(tail >= np.float32(cfg.postproc.fg_target_fraction)))
            fg_thr = float(np.clip((b - 0.5) / bins, 0.0, 1.0))
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
        if os.path.exists(fin_path):
            with open(fin_path) as f:
                fin = json.load(f)
            if fin.get("complete"):
                # the previous run finished: ``result`` holds the final labels
                if stats is not None:
                    stats["resumed_complete"] = True
                return result
            fin_done_upto = int(fin.get("done_upto", 0))
        while os.path.exists(chunk_path(start_ci)):
            start_ci += 1
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
            core, overlap_plane, me_lo, me_hi, n_trunc, ids, counts = \
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
        if device.type == "cuda":
            stats["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)

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
