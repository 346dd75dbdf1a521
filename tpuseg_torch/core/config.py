"""Config system of the port: its own copy of ``tpuseg/core/config.py``.

One nested frozen-dataclass tree that is JSON-serializable, CLI-overridable
(``--set train.lr=3e-4`` style) and saved into every checkpoint directory.
Field names, defaults and the JSON format are the JAX package's, so a config
file written by either package loads in the other
(``tests/test_torch_config.py`` holds the two schemas together). Fields that
select something only the JAX package has (``conv_impl``, ``program``, the
sharding fields) are kept for that reason; the port's modules say which
values they take.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """3D U-Net architecture."""

    in_channels: int = 1
    features: Tuple[int, ...] = (32, 64, 128, 256)  # encoder widths, last = bottleneck
    norm: str = "batch"           # "batch" (running stats; tile-exact) | "group" | "none"
    num_groups: int = 8
    activation: str = "relu"
    head_features: int = 32       # width of the shared head trunk
    conv_impl: str = "native"     # the JAX package's conv schedule; the port
                                  # has one (the library conv) and ignores it
    # dtype policy: fp32 params, bf16 compute (flipped off for parity tests)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class PostprocConfig:
    """On-device instance extraction."""

    peak_threshold: float = 0.5   # min peak-map prob for a seed
    fg_threshold: float = 0.5     # min fg-map prob for a voxel to join an instance
    nms_radius: int | tuple = 2   # NMS half-window: int or per-axis
                                  # (rz, ry, rx) — anisotropic stacks need a
                                  # smaller z footprint or z-stacked touching
                                  # instances suppress each other's peaks;
                                  # derive via ops.calibrate.nms_radius_from_half_sizes
    nms_impl: str = "xla"         # "xla" (seeds inside the fused seed pass,
                                  # ops/seed.py) | "pallas" (the peak-NMS
                                  # kernel, ops/nms.py, then the unfused
                                  # composition — ops/watershed.py)
    resolve_impl: str = "auto"    # chain-resolution/flood backend: "auto" /
                                  # "pallas" (the kernels) | "xla" (the plain
                                  # pointer jump; ops/watershed.py)
    min_size: int = 27            # drop instances smaller than this many voxels
    flood_iters: int = 96         # cap for the flood-fill fixed point (~max object diameter)
    method: str = "ascent"        # "ascent" (steepest-ascent basins) | "flood" (iterative)
    ascent_rounds: int = 8        # pointer-jump rounds of the "xla" resolve
    fg_target_fraction: float = 0.0  # >0: auto-calibrate fg_threshold so the
                                     # predicted fg volume fraction matches this
                                     # target (ops/calibrate.py) — corrects the
                                     # ~2x mask inflation of box supervision;
                                     # derive from annotations via
                                     # calibrate.expected_fg_fraction
    merge_saddle_ratio: float = 0.0  # >0: agglomerate adjacent basins whose
                                     # interface saddle >= ratio * the weaker
                                     # basin's peak; 0 = off
    merge_max_pairs: int = 1 << 17   # static cap on distinct adjacent label
                                     # pairs for the merge table


@dataclass(frozen=True)
class DataConfig:
    patch_size: Tuple[int, int, int] = (64, 64, 64)
    batch_size: int = 8
    max_instances: int = 64       # static cap on weak annotations per patch
    peak_sigma: float = 3.0       # gaussian radius of the peak target
    box_ignore_margin: int = 2    # ignore ring (voxels) around each box for fg loss
    normalize_pcts: Tuple[float, float] = (1.0, 99.8)
    normalize_sample_stride: int = 4  # histogram percentiles from every k-th
                                      # x-voxel
    augment: bool = True
    aug_zscale: Optional[Tuple[float, float]] = None
    # z-scale (anisotropy) augmentation range, e.g. (0.3, 1.0): each patch is
    # squashed along z by s ~ U(lo, hi) with annotations transformed to match
    # (data.augment). None = off.
    peak_sigma_aniso: bool = False
    # per-instance anisotropic peak-target sigma derived from the box aspect
    # (data.weak_targets.make_weak_targets aniso_sigma)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    total_steps: int = 5000
    peak_loss_weight: float = 1.0
    fg_loss_weight: float = 1.0
    dice_weight: float = 0.5
    seed: int = 0
    log_every: int = 20
    ckpt_every: int = 500
    ckpt_dir: str = "/tmp/tpuseg_ckpt"
    keep_ckpts: int = 3
    grad_accum: int = 1           # microbatches per optimizer step (k-times
                                  # larger effective batch at 1/k activation
                                  # memory; see train/step.py)
    data_axis: str = "data"       # DP mesh axis name (the JAX package's)
    apply_impl: str = "flax"      # train-mode forward: "flax" (the module
                                  # forward, autograd all the way) or "fused"
                                  # (full-res convs on the training conv
                                  # kernel — models/fused_train.py; requires
                                  # the flagship family)
    prefetch_depth: int = 2       # background batches sampled+uploaded ahead
                                  # of the device (data/prefetch.py); 0 = the
                                  # synchronous in-loop sampling
    # ---- validation (train/val.py) ----
    val_fraction: float = 0.0     # >0: hold out this fraction for validation
                                  # (whole volumes when >=2 given, a z-slab of
                                  # a single volume); 0 = off
    val_every: int = 100          # steps between validation evals
    val_patches: int = 16         # fixed val patches scored per eval
    val_f1: bool = False          # also run full val-volume inference and
                                  # score center-criterion instance F1
                                  # (annotation-only — works without GT masks)
    keep_best: bool = True        # retain the best-val-loss checkpoint under
                                  # <ckpt_dir>/best (needs val_fraction > 0)


@dataclass(frozen=True)
class InferConfig:
    tile: Tuple[int, int, int] = (32, 128, 128)   # core (written-back) tile shape
    halo: Any = 16              # context margin per tile face: scalar, or a
                                # per-axis (hd, hh, hw) tuple — axes covered
                                # by a single tile need no margin (exactness
                                # is per-axis; infer/tiles.py halo3)
    tile_batch: int = 1                           # tiles batched through the net
    compute_dtype: str = "bfloat16"
    apply_impl: str = "flax"    # eval forward: "flax" (the module forward) |
                                # "fused" (the fused full-res ConvBlock
                                # kernel, models/fused_eval.py — same
                                # function up to bf16 reassociation)
    program: str = "fused"      # the JAX package's XLA program structure:
                                # "fused" | "staged", checked, then the same
                                # computation (infer/pipeline.py)
    spatial_axes: Tuple[str, ...] = ("z",)        # mesh axes for sharded inference
    shard_halo: int = 32        # post-proc halo planes exchanged between shards
    shard_max_labels: int = 4096  # per-shard distinct-instance cap for the
                                  # global compaction gather


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    postproc: PostprocConfig = field(default_factory=PostprocConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)

    # ---- serialization ----

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def override(self, **dotted: Any) -> "Config":
        """Apply CLI-style dotted overrides, e.g. ``override(**{"train.lr": 1e-3})``."""
        d = self.to_dict()
        for key, val in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = val
        return Config.from_dict(d)


def _build(cls, d: dict):
    if not dataclasses.is_dataclass(cls):
        return d
    # resolve string annotations (PEP 563: `from __future__ import annotations`
    # makes f.type a string, so is_dataclass(f.type) would silently be False)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _build(ftype, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
