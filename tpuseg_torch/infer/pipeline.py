"""End-to-end inference (port of ``tpuseg/infer/pipeline.py``).

``make_infer_fn`` returns ``infer(volume) -> int32 labels`` for a (D, H, W)
tensor on any device:

  histogram-percentile scalars -> tiled halo-overlap net sweep (normalizing
  per block) -> sigmoid -> watershed (K1-K3 kernels on CUDA) -> size filter
  + compact 1..K relabel

PyTorch runs eagerly, so there is no ``jit``, no ``bind_variables`` and no
staged program: those exist to shape XLA programs on a TPU.
``InferConfig.program`` ("fused" / "staged") is read and ignored for that
reason — both name the same computation.
"""

from __future__ import annotations

import warnings

import torch

from tpuseg_torch.core import Config, InferConfig
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.data.normalize import histogram_percentile_scalars
from tpuseg_torch.infer.tiles import rf_radius_bound, tiled_forward
from tpuseg_torch.ops.filter import size_filter_and_compact
from tpuseg_torch.ops.watershed import flood_truncation_count, watershed


def _check_ported(cfg: Config) -> None:
    unported = [
        # the default apply is the plain module forward; "fused" (K4) waits
        ("infer.apply_impl", cfg.infer.apply_impl != InferConfig.apply_impl),
        ("postproc.fg_target_fraction", cfg.postproc.fg_target_fraction > 0),
        ("postproc.merge_saddle_ratio", cfg.postproc.merge_saddle_ratio > 0),
    ]
    for key, bad in unported:
        if bad:
            raise NotImplementedError(
                f"{key} is not ported yet; see ROADMAP.md")


def _postprocess(fg_prob, peak_prob, cfg: Config, want_diag: bool,
                 plain: bool):
    pp = cfg.postproc
    labels = watershed(fg_prob, peak_prob, peak_threshold=pp.peak_threshold,
                       fg_threshold=pp.fg_threshold,
                       peak_radius=pp.nms_radius, flood_iters=pp.flood_iters,
                       method=pp.method, nms_impl=pp.nms_impl,
                       resolve_impl=pp.resolve_impl, label_space="index",
                       plain=plain)
    diag = None
    if want_diag:
        # measured on the raw watershed output, before filtering
        diag = {"flood_truncated": int(flood_truncation_count(
            labels, fg_prob >= pp.fg_threshold))}
    labels = size_filter_and_compact(labels, pp.min_size)
    return (labels, diag) if want_diag else labels


def make_infer_stages(model, cfg: Config, normalize: bool = True,
                      with_diagnostics: bool = False, plain: bool = False):
    """``(infer, stage_net, stage_post)``: ``stage_net(volume)`` gives the
    logits, ``stage_post(logits)`` the labels (and diagnostics), ``infer``
    chains them. ``plain=True`` runs the watershed's plain twins instead of
    the CUDA kernels (the card's end-to-end check of the kernels)."""
    _check_ported(cfg)
    compute_dtype = resolve(cfg.infer.compute_dtype)
    # float32 convolutions in full float32: cuDNN would take TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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

        return tiled_forward(model, vol, tile=cfg.infer.tile, halo=halo,
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
