"""Training step (port of ``tpuseg/train/step.py``).

One step: per-patch normalization, weak-target synthesis, augmentation,
forward (module path, or ``train.apply_impl="fused"`` with the K6 convs),
loss, backward, global-norm clipping and AdamW — all on the batch's device.
PyTorch runs eagerly, so there is no jit; the host feeds raw patches and
annotations.

State is a :class:`TrainState`: the model (parameters and BatchNorm running
statistics, updated in place by the train-mode forward), the optimizer state
and the step count.

Data parallelism (``axis_name``: a ``torch.distributed`` process group, see
``train/dp.py``): each rank steps on its slice of the global batch, its
examples numbered from ``rank * local batch`` so that the augmentation draws
the single-device run's; after the backward pass the gradients and the
metrics are averaged over the ranks in one flattened buffer, so the norm,
the clipping and AdamW run identically on every rank. The reduction is
explicit rather than ``DistributedDataParallel``'s, whose reducer hooks
the wrapper's forward (the fused apply calls submodules directly).

The optimizer reproduces ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...)))`` (``make_optimizer``):

* schedule: linear warmup from ``lr / warmup`` to ``lr``, then a cosine to 0
  at ``max(total, warmup + 1)``; update k (0-based) uses the value at k;
* clipping: ``g if norm < 1 else g / norm * 1`` (optax's select, not
  ``torch.nn.utils.clip_grad_norm_``'s ``1 / (norm + 1e-6)``);
* AdamW: bias-corrected moments, ``u = m / (sqrt(v) + 1e-8) + wd * p``,
  ``p += -lr * u``; the decay applies to every parameter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch.core import Config, TrainConfig
from tpuseg_torch.data.augment import (apply_augment, apply_zscale,
                                       draw_augment_params, draw_zscale)
from tpuseg_torch.data.normalize import histogram_percentile_normalize
from tpuseg_torch.data.weak_targets import make_weak_targets
from tpuseg_torch.losses import total_loss
from tpuseg_torch.parallel.collectives import group_mean

# random streams of one example (the JAX package's fold_in(key, idx) and
# fold_in(fold_in(key, idx), 1))
_AUGMENT, _ZSCALE = 0, 1


def lr_schedule(cfg: TrainConfig):
    """``optax.warmup_cosine_decay_schedule`` as ``make_optimizer`` builds
    it, in float32 arithmetic: ``count -> learning rate``."""
    f32 = np.float32
    warmup = cfg.warmup_steps
    peak = cfg.lr
    init = cfg.lr / max(warmup, 1)
    decay = max(cfg.total_steps, warmup + 1) - warmup

    def sched(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(peak) * cos)

    return sched


class AdamW:
    """``make_optimizer``'s optax chain over a model's parameters (see the
    module docstring). State: ``count`` and the moments ``mu``/``nu`` by
    parameter name."""

    b1, b2, eps, max_norm = 0.9, 0.999, 1e-8, 1.0

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig):
        self.schedule = lr_schedule(cfg)
        self.weight_decay = cfg.weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor):
        """One update of ``params`` in place, from ``grads`` and their
        global norm (taken before clipping)."""
        keep = grad_norm < self.max_norm
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for k, p in params.items():
            g = torch.where(keep, grads[k], grads[k] / grad_norm * self.max_norm)
            mu = (1 - self.b1) * g + self.b1 * self.mu[k]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            self.mu[k], self.nu[k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * -lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, d: dict) -> None:
        self.count = int(d["count"])
        for k in self.mu:
            self.mu[k] = d["mu"][k].to(self.mu[k].device)
            self.nu[k] = d["nu"][k].to(self.nu[k].device)


@dataclass
class TrainState:
    """Model (parameters + BatchNorm statistics), optimizer, step count."""

    model: torch.nn.Module
    opt: AdamW
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def make_optimizer(model: torch.nn.Module, cfg: Config) -> AdamW:
    return AdamW(dict(model.named_parameters()), cfg.train)


def create_train_state(model: torch.nn.Module, cfg: Config) -> TrainState:
    """The model's current weights as step 0 (load a checkpoint into the
    model first to start from it)."""
    return TrainState(model=model, opt=make_optimizer(model, cfg), step=0)


def example_generator(seed: int, step: int, index: int, stream: int,
                      device) -> torch.Generator:
    """The generator of one example's random stream, a pure function of
    (seed, step, global example index, stream): resume and grad
    accumulation draw the same augmentations as an uninterrupted,
    unaccumulated run."""
    state = np.random.SeedSequence([seed, step, index, stream]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def prepare_batch(batch: Dict[str, torch.Tensor], cfg: Config, seed: int,
                  step: int, example_offset: int = 0):
    """Raw sampler batch (on the device) -> ((B, D, H, W) images, target
    dict), in ``prepare_batch``'s order: normalize, z-scale, weak targets,
    z_weight into fg_weight, augment."""
    imgs = histogram_percentile_normalize(batch["image"],
                                          cfg.data.normalize_pcts)
    centers = batch["centers"].float()
    halfs = batch["half_sizes"].float()
    valid = batch["valid"].bool()
    dev = imgs.device
    b = imgs.shape[0]
    z_weight = None
    if cfg.data.augment and cfg.data.aug_zscale is not None:
        outs = []
        for i in range(b):
            g = example_generator(seed, step, example_offset + i, _ZSCALE, dev)
            s = draw_zscale(g, cfg.data.aug_zscale)
            outs.append(apply_zscale(s, imgs[i], centers[i], halfs[i],
                                     valid[i]))
        imgs, centers, halfs, valid, z_weight = (torch.stack(t)
                                                 for t in zip(*outs))
    tgt = make_weak_targets(centers, halfs, valid, tuple(imgs.shape[1:]),
                            peak_sigma=cfg.data.peak_sigma,
                            margin=cfg.data.box_ignore_margin,
                            aniso_sigma=cfg.data.peak_sigma_aniso)
    if z_weight is not None:
        tgt["fg_weight"] = tgt["fg_weight"] * z_weight[:, :, None, None]
    if cfg.data.augment:
        out_imgs, out_tgts = [], []
        for i in range(b):
            g = example_generator(seed, step, example_offset + i, _AUGMENT,
                                  dev)
            p = draw_augment_params(g, imgs.shape[1:])
            im, tg = apply_augment(p, imgs[i], {k: v[i] for k, v in tgt.items()})
            out_imgs.append(im)
            out_tgts.append(tg)
        imgs = torch.stack(out_imgs)
        tgt = {k: torch.stack([t[k] for t in out_tgts]) for k in tgt}
    return imgs, tgt


def loss_fn(model, batch, cfg: Config, seed: int, step: int,
            example_offset: int = 0, apply_fn=None):
    """``(loss, metrics)`` of the train-mode forward on one (micro)batch;
    ``apply_fn`` (``models/fused_train``) replaces ``model(x)``."""
    imgs, tgts = prepare_batch(batch, cfg, seed, step, example_offset)
    out = (apply_fn or model)(imgs)
    return total_loss(out, tgts, cfg.train)


def _flatten(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors.values()])


def _unflatten(flat: torch.Tensor, like: Dict[str, torch.Tensor]) -> dict:
    """``flat`` cut back into tensors shaped as ``like``'s values."""
    out, at = {}, 0
    for k, t in like.items():
        out[k] = flat[at:at + t.numel()].view_as(t)
        at += t.numel()
    return out


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every entry."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def make_train_step(model, cfg: Config, axis_name=None, grad_accum: int = 1):
    """Build ``step(state, batch, seed) -> metrics``: one optimizer update of
    ``state`` in place; metrics (0-d device tensors) ``loss``,
    ``peak_loss``, ``fg_loss`` and ``grad_norm`` (before clipping).

    ``seed`` keys the augmentation (the JAX loop's ``train.seed + 1``);
    ``grad_accum`` > 1 splits the batch into that many microbatches whose
    gradients and metrics are averaged before one update, BatchNorm
    statistics carrying from one microbatch to the next.

    ``axis_name``: a process group of data parallelism (the JAX package's
    mesh axis name); ``batch`` is then this rank's slice of the global
    batch, and the model's BatchNorms should share its statistics
    (``train/dp.make_dp_train_step`` sets both up)."""
    group = axis_name
    apply_fn = None
    if cfg.train.apply_impl == "fused":
        from tpuseg_torch.models.fused_train import make_fused_train_apply

        apply_fn = make_fused_train_apply(model)
    elif cfg.train.apply_impl != "flax":
        raise ValueError(f"unknown TrainConfig.apply_impl "
                         f"{cfg.train.apply_impl!r}")
    # float32 convolutions in full float32: cuDNN would take TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def step(state: TrainState, batch, seed: int):
        model.train()
        params = state.params()
        for p in params.values():
            p.grad = None
        b = batch["image"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} "
                             "microbatches")
        mb = b // grad_accum
        # global index of this rank's first example: the augmentation keys
        # of a single-device run
        offset = 0 if group is None else dist.get_rank(group) * b
        macc = None
        for j in range(grad_accum):
            micro = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
            loss, metrics = loss_fn(model, micro, cfg, seed, state.step,
                                    offset + j * mb, apply_fn)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            macc = metrics if macc is None else {
                k: macc[k] + metrics[k] for k in macc}
        grads = {k: p.grad / grad_accum if grad_accum > 1 else p.grad
                 for k, p in params.items()}
        if grad_accum > 1:
            macc = {k: v / grad_accum for k, v in macc.items()}
        if group is not None:
            # one all-reduce: the gradients, then the metrics
            flat = group_mean(torch.cat([_flatten(grads), _flatten(macc)]),
                              group)
            n = sum(g.numel() for g in grads.values())
            grads, macc = _unflatten(flat[:n], grads), _unflatten(flat[n:],
                                                                 macc)
        gnorm = global_norm(grads.values())
        state.opt.update(params, grads, gnorm)
        for p in params.values():
            p.grad = None
        state.step += 1
        return dict(macc, grad_norm=gnorm)

    return step
