"""End-to-end inference (port of ``tpuseg/infer/pipeline.py``).

``make_infer_fn`` returns ``infer(volume) -> int32 labels`` for a (D, H, W)
tensor on any device:

  histogram-percentile scalars -> tiled halo-overlap net sweep (normalizing
  per block) -> sigmoid -> watershed (K1-K3 kernels on CUDA) -> saddle
  merge (``postproc.merge_saddle_ratio > 0``) -> size filter + compact 1..K
  relabel

``make_batched_infer_fn`` runs a stacked (N, D, H, W) batch through the same
function volume by volume, and ``infer_volume`` is the one-shot
convenience call.

On the card the whole call is enqueued without a host read, as the
reference runs it as one jitted program: the percentile scalars, the
calibrated threshold and the size filter's label counts come from kernels
of their own (``ops/hist.py``) and stay on the device, K1 and K5 read their
thresholds from device memory, and the chase and the flood loop on the
device (``ops/resolve.py``). The saddle merge (``postproc.merge_saddle_ratio
> 0``) sorts fixed-size pair tables and closes them on U1
(``ops/merge.py``), and ``with_diagnostics=True`` returns the truncation
count as a 0-d device tensor, as the reference does; the merge's dropped
count stays on ``ops.merge.saddle_merge.last_dropped``. So the call can
be captured as one CUDA graph (below). The streamed path reads the host
between chunks (``infer/streaming.py``).

``InferConfig.apply_impl`` selects the sweep's forward: "flax" is the module
forward, "fused" the eval apply of ``models/fused_eval.py`` (the three
full-resolution ConvBlocks on the K4 kernel).

The reference runs these calls as jitted XLA programs; here, on the card,
:func:`make_infer_fn`, :func:`make_batched_infer_fn` and
:func:`infer_volume` run them as captured CUDA graphs (``infer/graph.py``):
the first call of a shape runs the eager body, the second captures it, and
later calls replay the graph. ``InferConfig.program`` keeps its reference
meaning: "fused" captures the whole call as one graph, "staged" as two,
the sweep (``stage_net``) and the post-processing (``stage_post``), on one
memory pool; any other value raises ``ValueError``. Settings whose body
reads the host (``postproc.resolve_impl="xla"``,
``graph.eager_reason``) run eagerly on every call, and the program's
``.mode`` says so. The eager body is the returned program's ``.eager``,
and :func:`make_infer_stages` returns the eager stages (the checks compare
the graphs with them). There is no ``bind_variables``: a graph reads the
model's weights where they are, and the program starts over when they
move (``graph.module_state``).
"""

from __future__ import annotations

import warnings

import torch

from tpuseg_torch.core import Config
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.data.normalize import histogram_percentile_scalars
from tpuseg_torch.infer.graph import (CapturedProgram, Chain, eager_reason,
                                      module_state)
from tpuseg_torch.infer.tiles import rf_radius_bound, tiled_forward
from tpuseg_torch.ops.calibrate import threshold_for_fraction
from tpuseg_torch.ops.filter import size_filter_and_compact
from tpuseg_torch.ops.merge import saddle_merge
from tpuseg_torch.ops.watershed import (flood_truncation_count,
                                        threshold_mask, watershed)
from tpuseg_torch.utils.profiling import mark


def norm_scalars(lo, hi):
    """``(lo, span)`` of the percentile scalars ``lo`` and ``hi`` (0-d
    tensors), for :func:`block_logits`: ``span = max(hi - lo, 1e-6)``."""
    return lo, torch.clamp(hi - lo, min=1e-6)


def block_logits(apply_fn, block: torch.Tensor, norm, cfg: Config, halo):
    """``tiled_forward``'s ``{"fg_logits", "peak_logits"}`` of a (D, H, W)
    block (read as float32) under ``apply_fn``, with ``cfg.infer``'s tile,
    tile batch and compute dtype and the given ``halo``. ``norm``: the
    :func:`norm_scalars` ``(lo, span)``, each tile block then normalized to
    ``clamp((b - lo) / span, 0, 1)`` (elementwise, so equal to normalizing
    the block first), or ``None`` for no normalization. Every inference
    body sweeps its blocks through this."""
    preprocess = None
    if norm is not None:
        lo, span = norm

        def preprocess(b):
            return torch.clamp((b - lo) / span, 0.0, 1.0)

    return tiled_forward(apply_fn, block.float(), tile=cfg.infer.tile,
                         halo=halo, tile_batch=cfg.infer.tile_batch,
                         compute_dtype=resolve(cfg.infer.compute_dtype),
                         preprocess=preprocess)


def watershed_labels(fg, pk, pp, fg_threshold, plain: bool = False):
    """The watershed of the maps ``fg`` and ``pk`` under ``pp`` (a
    ``PostprocConfig``) at ``fg_threshold`` (a float, or a 0-d tensor that
    compares in float32, ``ops.watershed.threshold_mask``): int32 labels,
    each basin its root's linear index + 1. Every inference body labels
    through this."""
    return watershed(fg, pk, peak_threshold=pp.peak_threshold,
                     fg_threshold=fg_threshold, peak_radius=pp.nms_radius,
                     flood_iters=pp.flood_iters, method=pp.method,
                     ascent_rounds=pp.ascent_rounds, nms_impl=pp.nms_impl,
                     resolve_impl=pp.resolve_impl, label_space="index",
                     plain=plain)


def _postprocess(fg_prob, peak_prob, cfg: Config, want_diag: bool,
                 plain: bool):
    pp = cfg.postproc
    fg_threshold = pp.fg_threshold
    if pp.fg_target_fraction > 0:
        # volume-matched threshold (ops/calibrate.py): a 0-d tensor that
        # stays on the device, as the reference keeps it traced
        fg_threshold = threshold_for_fraction(
            fg_prob, pp.fg_target_fraction,
            sample_stride=cfg.data.normalize_sample_stride, plain=plain)
    labels = watershed_labels(fg_prob, peak_prob, pp, fg_threshold, plain)
    diag = None
    if want_diag:
        # measured on the raw watershed output, before filtering; a 0-d
        # int32 device tensor, read by whoever reads the labels
        diag = {"flood_truncated": flood_truncation_count(
            labels, threshold_mask(fg_prob, fg_threshold))}
    if pp.merge_saddle_ratio > 0:
        # prominence agglomeration: basins split by duplicate peaks on a
        # flat top merge; real instances keep their valley
        labels = saddle_merge(labels, peak_prob, pp.merge_saddle_ratio,
                              max_pairs=pp.merge_max_pairs, plain=plain)
    mark("filter", labels)
    labels = size_filter_and_compact(labels, pp.min_size, plain=plain)
    return (labels, diag) if want_diag else labels


def make_apply_fn(model, cfg: Config, plain: bool = False):
    """The sweep's forward under ``infer.apply_impl``: the module ("flax")
    or the fused eval apply ("fused"; K4's twin with ``plain=True``).
    Float32 convolutions then run in full float32 (cuDNN would take TF32)."""
    if cfg.infer.apply_impl == "fused":
        from tpuseg_torch.models.fused_eval import make_fused_apply

        apply_fn = make_fused_apply(model, plain=plain)
    elif cfg.infer.apply_impl == "flax":
        apply_fn = model
    else:
        raise ValueError(f"unknown apply_impl {cfg.infer.apply_impl!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return apply_fn


def make_infer_stages(model, cfg: Config, normalize: bool = True,
                      with_diagnostics: bool = False, plain: bool = False):
    """``(infer, stage_net, stage_post)``: ``stage_net(volume)`` gives the
    logits, ``stage_post(logits)`` the labels (and diagnostics), ``infer``
    chains them. ``plain=True`` runs the plain twins of the post-processing's
    kernels (the calibrated threshold's histogram, the watershed, the
    merge's closure, the size filter's counts) and of the fused apply's
    instead of the CUDA kernels (the card's end-to-end check of the
    kernels); the percentile scalars of ``stage_net`` still come from H1
    and H2."""
    apply_fn = make_apply_fn(model, cfg, plain)
    if cfg.infer.program not in ("fused", "staged"):
        raise ValueError(f"unknown InferConfig.program {cfg.infer.program!r}")

    # receptive field of the model actually supplied (stand-ins carry no
    # .config and trip no warning)
    features = getattr(getattr(model, "config", None), "features", None)
    rf = rf_radius_bound(len(features)) if features is not None else None
    per_axis_halo = isinstance(cfg.infer.halo, (tuple, list))
    halo = tuple(cfg.infer.halo) if per_axis_halo else cfg.infer.halo
    if rf is not None and not per_axis_halo and halo < rf:
        warnings.warn(
            f"InferConfig.halo={halo} is below the {len(features)}-level "
            f"model's receptive-field radius (~{rf}): tiled inference is "
            f"border-approximate, not voxel-exact. Set infer.halo>={rf} for "
            "exactness (slower).", stacklevel=3)

    def _check_per_axis_halo(shape):
        # exactness needs halo >= RF only on axes the tile grid splits
        if rf is None or not per_axis_halo:
            return
        split = [-(-s // t) > 1 for s, t in zip(shape, cfg.infer.tile)]
        bad = [("zyx"[a], halo[a]) for a in range(3) if split[a] and halo[a] < rf]
        if bad:
            warnings.warn(
                f"InferConfig.halo={halo}: tiled axes {bad} have halo below "
                f"the model's receptive-field radius (~{rf}): inference is "
                "border-approximate on those seams.", stacklevel=3)

    @torch.inference_mode()
    def stage_net(volume: torch.Tensor):
        _check_per_axis_halo(volume.shape)
        mark("norm", volume)
        vol = volume.float()
        # scalars only; the normalization runs per tile block
        norm = (norm_scalars(*histogram_percentile_scalars(
            vol, cfg.data.normalize_pcts,
            sample_stride=cfg.data.normalize_sample_stride))
            if normalize else None)
        return block_logits(apply_fn, vol, norm, cfg, halo)

    @torch.inference_mode()
    def stage_post(out):
        mark("watershed", out["fg_logits"])
        fg_prob = torch.sigmoid(out["fg_logits"])
        peak_prob = torch.sigmoid(out["peak_logits"])
        return _postprocess(fg_prob, peak_prob, cfg, with_diagnostics, plain)

    def infer(volume: torch.Tensor):
        return stage_post(stage_net(volume))

    return infer, stage_net, stage_post


def _captured(model, cfg: Config, infer, stage_net, stage_post,
              name: str = "infer"):
    """``InferConfig.program``'s structure as captured graphs: "fused" one
    program of ``infer``, "staged" ``stage_net`` then ``stage_post``
    (named ``<name>.net`` and ``<name>.post``); eager on every call where
    ``graph.eager_reason`` says so."""
    kw = {"context": lambda: module_state(model),
          "eager_reason": eager_reason(cfg)}
    if cfg.infer.program == "staged":
        return Chain(stage_net, stage_post, eager=infer,
                     names=(f"{name}.net", f"{name}.post"), **kw)
    return CapturedProgram(infer, name=name, **kw)


def make_infer_fn(model, cfg: Config, normalize: bool = True,
                  with_diagnostics: bool = False):
    """``infer(volume) -> int32 labels`` (D, H, W), on ``volume``'s device;
    ``model`` is any module mapping (B, 1, d, h, w) blocks to
    ``{"fg_logits", "peak_logits"}`` and must sit on that device. On the
    card the call runs as a captured graph from its second call of a shape
    on (module docstring); ``infer.eager`` is the eager body, ``infer.mode``
    "captured" or why every call runs eagerly, and ``infer.release()``
    frees the graphs and their memory pool.

    ``with_diagnostics=True``: ``infer`` returns ``(labels, diag)`` with
    ``diag["flood_truncated"]`` (``ops.watershed.flood_truncation_count``,
    a 0-d int32 tensor on the volume's device; zero iff the flood
    converged)."""
    return _captured(model, cfg, *make_infer_stages(model, cfg, normalize,
                                                    with_diagnostics))


def make_batched_infer_fn(model, cfg: Config, normalize: bool = True):
    """``infer(volumes) -> int32 labels`` (N, D, H, W) for a stacked
    (N, D, H, W) tensor: each volume normalized with its own percentiles
    and labelled independently by :func:`make_infer_fn`'s body, one after
    the other, into one label tensor on the volumes' device. On the card
    the whole loop is one captured graph from the second call of a shape on
    (two under ``program="staged"``: every volume's sweep, then every
    volume's post-processing), as the reference maps the volumes inside one
    program without a host round trip."""
    infer, stage_net, stage_post = make_infer_stages(model, cfg, normalize)

    def infer_batch(volumes: torch.Tensor) -> torch.Tensor:
        out = torch.empty(volumes.shape, dtype=torch.int32,
                          device=volumes.device)
        for i in range(volumes.shape[0]):
            out[i] = infer(volumes[i])
        return out

    def net_batch(volumes: torch.Tensor) -> list:
        return [stage_net(v) for v in volumes]

    def post_batch(outs: list) -> torch.Tensor:
        return torch.stack([stage_post(o) for o in outs])

    return _captured(model, cfg, infer_batch, net_batch, post_batch,
                     name="infer.batch")


def infer_volume(model, volume, cfg: Config, normalize: bool = True,
                 device="cuda") -> torch.Tensor:
    """One-shot :func:`make_infer_fn` on ``volume`` (array or tensor),
    moved to ``device`` first; ``model`` must sit there. The function is
    kept on the model, one per ``cfg`` and ``normalize``, for as long as
    the model lives, so a second call of a shape captures it and later
    calls replay it; its graphs keep their memory pool reserved until
    ``release_infer_volume(model)``."""
    programs = model.__dict__.setdefault("_infer_volume_programs", {})
    key = (cfg, normalize)
    if key not in programs:
        programs[key] = make_infer_fn(model, cfg, normalize)
    return programs[key](torch.as_tensor(volume, device=device))


def release_infer_volume(model) -> None:
    """Free the graphs, and their memory pools, that :func:`infer_volume`
    keeps on ``model``."""
    for program in model.__dict__.pop("_infer_volume_programs", {}).values():
        program.release()
