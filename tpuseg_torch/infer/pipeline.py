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

``InferConfig.apply_impl`` selects the sweep's forward: "flax" is the module
forward, "fused" the eval apply of ``models/fused_eval.py`` (the three
full-resolution ConvBlocks on the K4 kernel).

PyTorch runs eagerly, so there is no ``jit``, no ``bind_variables`` and no
staged program: those exist to shape XLA programs on a TPU.
``InferConfig.program`` ("fused" / "staged") is checked, then both name the
same computation; any other value raises ``ValueError`` as in the reference.
"""

from __future__ import annotations

import warnings

import torch

from tpuseg_torch.core import Config
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.data.normalize import histogram_percentile_scalars
from tpuseg_torch.infer.tiles import rf_radius_bound, tiled_forward
from tpuseg_torch.ops.calibrate import threshold_for_fraction
from tpuseg_torch.ops.filter import size_filter_and_compact
from tpuseg_torch.ops.merge import saddle_merge
from tpuseg_torch.ops.watershed import flood_truncation_count, watershed


def _postprocess(fg_prob, peak_prob, cfg: Config, want_diag: bool,
                 plain: bool):
    pp = cfg.postproc
    fg_threshold = pp.fg_threshold
    if pp.fg_target_fraction > 0:
        # volume-matched threshold (ops/calibrate.py); one host read
        fg_threshold = float(threshold_for_fraction(
            fg_prob, pp.fg_target_fraction,
            sample_stride=cfg.data.normalize_sample_stride))
    labels = watershed(fg_prob, peak_prob, peak_threshold=pp.peak_threshold,
                       fg_threshold=fg_threshold,
                       peak_radius=pp.nms_radius, flood_iters=pp.flood_iters,
                       method=pp.method, ascent_rounds=pp.ascent_rounds,
                       nms_impl=pp.nms_impl,
                       resolve_impl=pp.resolve_impl, label_space="index",
                       plain=plain)
    diag = None
    if want_diag:
        # measured on the raw watershed output, before filtering
        diag = {"flood_truncated": int(flood_truncation_count(
            labels, fg_prob >= fg_threshold))}
    if pp.merge_saddle_ratio > 0:
        # prominence agglomeration: basins split by duplicate peaks on a
        # flat top merge; real instances keep their valley
        labels = saddle_merge(labels, peak_prob, pp.merge_saddle_ratio,
                              max_pairs=pp.merge_max_pairs)
    labels = size_filter_and_compact(labels, pp.min_size)
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
    chains them. ``plain=True`` runs the plain twins of the watershed's and
    the fused apply's kernels instead of the CUDA kernels (the card's
    end-to-end check of the kernels)."""
    apply_fn = make_apply_fn(model, cfg, plain)
    if cfg.infer.program not in ("fused", "staged"):
        raise ValueError(f"unknown InferConfig.program {cfg.infer.program!r}")
    compute_dtype = resolve(cfg.infer.compute_dtype)

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
        vol = volume.float()
        preprocess = None
        if normalize:
            # scalars only; the normalization runs per tile block
            p_lo, p_hi = histogram_percentile_scalars(
                vol, cfg.data.normalize_pcts,
                sample_stride=cfg.data.normalize_sample_stride)
            span = torch.clamp(p_hi - p_lo, min=1e-6)

            def preprocess(b):
                return torch.clamp((b - p_lo) / span, 0.0, 1.0)

        return tiled_forward(apply_fn, vol, tile=cfg.infer.tile, halo=halo,
                             tile_batch=cfg.infer.tile_batch,
                             compute_dtype=compute_dtype,
                             preprocess=preprocess)

    @torch.inference_mode()
    def stage_post(out):
        fg_prob = torch.sigmoid(out["fg_logits"])
        peak_prob = torch.sigmoid(out["peak_logits"])
        return _postprocess(fg_prob, peak_prob, cfg, with_diagnostics, plain)

    def infer(volume: torch.Tensor):
        return stage_post(stage_net(volume))

    return infer, stage_net, stage_post


def make_infer_fn(model, cfg: Config, normalize: bool = True,
                  with_diagnostics: bool = False):
    """``infer(volume) -> int32 labels`` (D, H, W), on ``volume``'s device;
    ``model`` is any module mapping (B, 1, d, h, w) blocks to
    ``{"fg_logits", "peak_logits"}`` and must sit on that device.

    ``with_diagnostics=True``: ``infer`` returns ``(labels, diag)`` with
    ``diag["flood_truncated"]`` (``ops.watershed.flood_truncation_count``;
    zero iff the flood converged)."""
    return make_infer_stages(model, cfg, normalize, with_diagnostics)[0]


def make_batched_infer_fn(model, cfg: Config, normalize: bool = True):
    """``infer(volumes) -> int32 labels`` (N, D, H, W) for a stacked
    (N, D, H, W) tensor: each volume normalized with its own percentiles
    and labelled independently by :func:`make_infer_fn`'s function, one
    after the other, into one label tensor on the volumes' device. Nothing
    volume-sized leaves the device; the host reads are each volume's own
    scalar reads (its 4096 histogram counts, the calibrated threshold where
    ``postproc.fg_target_fraction > 0``, the chase's and flood's
    convergence flags)."""
    infer = make_infer_fn(model, cfg, normalize)

    def infer_batch(volumes: torch.Tensor) -> torch.Tensor:
        out = torch.empty(volumes.shape, dtype=torch.int32,
                          device=volumes.device)
        for i in range(volumes.shape[0]):
            out[i] = infer(volumes[i])
        return out

    return infer_batch


def infer_volume(model, volume, cfg: Config, normalize: bool = True,
                 device="cuda") -> torch.Tensor:
    """One-shot :func:`make_infer_fn` on ``volume`` (array or tensor),
    moved to ``device`` first; ``model`` must sit there."""
    return make_infer_fn(model, cfg, normalize)(
        torch.as_tensor(volume, device=device))
