"""Training step (port of ``tpuseg/train/step.py``).

One step: per-patch normalization, weak-target synthesis, augmentation,
forward (module path, or ``train.apply_impl="fused"`` with the K6 convs),
loss, backward, global-norm clipping and AdamW — all on the batch's device;
the host feeds raw patches and annotations.

The reference jits the whole step (``jax.jit(make_train_step(...))``). Here
the step is a :class:`TrainStep`: its body ``body(batch, hyper)`` runs as a
:class:`~tpuseg_torch.infer.graph.CapturedProgram`, eager at a batch
shape's first step, captured as a CUDA graph at its second and replayed
after. So the body reads nothing from the host that changes from step to
step: the learning rate and AdamW's bias corrections enter as the float32
device tensor ``hyper``, the augmentation draws from a bank of device
generators that the wrapper reseeds before each step, the optimizer's
moments are written in place, and the wrapper, not the body, advances the
host counters (``state.step``, ``opt.count``). A step under a process group
runs eagerly on every call (``graph.train_eager_reason``), as do CPU
tensors.

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
from tpuseg_torch.infer.graph import (CapturedProgram, module_state,
                                      train_eager_reason)
from tpuseg_torch.losses import total_loss
from tpuseg_torch.ops._build import device_scalars
from tpuseg_torch.parallel.collectives import group_mean
from tpuseg_torch.utils.profiling import mark, span

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
    parameter name, updated in place (a captured step keeps their
    addresses)."""

    b1, b2, eps, max_norm = 0.9, 0.999, 1e-8, 1.0

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig):
        self.schedule = lr_schedule(cfg)
        self.weight_decay = cfg.weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def hyper(self, device) -> torch.Tensor:
        """The next update's ``[lr, 1 - b1^t, 1 - b2^t]`` (t = count + 1),
        computed in float32 on the host, as a (3,) float32 tensor on
        ``device`` (fills: no blocking copy)."""
        f32 = np.float32
        t = f32(self.count + 1)
        return device_scalars(self.schedule(self.count),
                              f32(1) - f32(self.b1) ** t,
                              f32(1) - f32(self.b2) ** t, device=device)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor):
        """One update of ``params`` in place, from ``grads`` and their
        global norm (taken before clipping); advances ``count``."""
        hyper = self.hyper(grad_norm.device)
        self.count += 1
        self.apply(params, grads, grad_norm, hyper)

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor,
              hyper: torch.Tensor):
        """:meth:`update`'s arithmetic with its per-step values taken from
        ``hyper`` (:meth:`hyper`); reads and changes no host state."""
        keep = grad_norm < self.max_norm
        lr, bc1, bc2 = hyper
        for k, p in params.items():
            g = torch.where(keep, grads[k], grads[k] / grad_norm * self.max_norm)
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * -lr)

    def moments(self) -> tuple:
        return (*self.mu.values(), *self.nu.values())

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, d: dict) -> None:
        """Copies the moments into the tensors this optimizer holds."""
        self.count = int(d["count"])
        for k in self.mu:
            self.mu[k].copy_(d["mu"][k])
            self.nu[k].copy_(d["nu"][k])


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


def example_seed(seed: int, step: int, index: int, stream: int) -> int:
    """The seed of one example's random stream, a pure function of (seed,
    step, global example index, stream): resume and grad accumulation draw
    the same augmentations as an uninterrupted, unaccumulated run."""
    state = np.random.SeedSequence([seed, step, index, stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def example_generator(seed: int, step: int, index: int, stream: int,
                      device) -> torch.Generator:
    """A fresh generator of one example's random stream
    (:func:`example_seed`)."""
    g = torch.Generator(device=device)
    g.manual_seed(example_seed(seed, step, index, stream))
    return g


def augment_streams(cfg: Config) -> tuple:
    """The random streams :func:`prepare_batch` draws from under ``cfg``."""
    if not cfg.data.augment:
        return ()
    zscale = (_ZSCALE,) if cfg.data.aug_zscale is not None else ()
    return zscale + (_AUGMENT,)


class GeneratorBank:
    """Generators on one device, one per (stream, example of a batch), kept
    from step to step: a captured step draws from generators registered
    with its graph, so each step reseeds these in place on the host
    (``manual_seed`` also rewinds the offset) instead of making new ones.
    After :meth:`reseed` a bank draws what fresh generators of
    :func:`example_generator` draw."""

    def __init__(self, streams, device):
        self.device = torch.device(device)
        self.generators = {s: [] for s in streams}

    def reseed(self, seed: int, step: int, offset: int, n: int) -> dict:
        """Reseed the first ``n`` generators of each stream for the global
        examples ``offset .. offset + n - 1`` of ``step``; returns them, by
        stream."""
        out = {}
        for s, gens in self.generators.items():
            while len(gens) < n:
                gens.append(torch.Generator(device=self.device))
            for i, g in enumerate(gens[:n]):
                g.manual_seed(example_seed(seed, step, offset + i, s))
            out[s] = gens[:n]
        return out


def prepare_batch(batch: Dict[str, torch.Tensor], cfg: Config, seed: int,
                  step: int, example_offset: int = 0, generators=None):
    """Raw sampler batch (on the device) -> ((B, D, H, W) images, target
    dict), in ``prepare_batch``'s order: normalize, z-scale, weak targets,
    z_weight into fg_weight, augment. ``generators``: the examples' seeded
    generators by stream (``GeneratorBank.reseed``) in place of fresh ones
    from (``seed``, ``step``, ``example_offset``)."""
    imgs = histogram_percentile_normalize(batch["image"],
                                          cfg.data.normalize_pcts)
    centers = batch["centers"].float()
    halfs = batch["half_sizes"].float()
    valid = batch["valid"].bool()
    dev = imgs.device
    b = imgs.shape[0]

    def generator(i, stream):
        if generators is not None:
            return generators[stream][i]
        return example_generator(seed, step, example_offset + i, stream, dev)

    z_weight = None
    if cfg.data.augment and cfg.data.aug_zscale is not None:
        outs = []
        for i in range(b):
            s = draw_zscale(generator(i, _ZSCALE), cfg.data.aug_zscale)
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
            p = draw_augment_params(generator(i, _AUGMENT), imgs.shape[1:])
            im, tg = apply_augment(p, imgs[i], {k: v[i] for k, v in tgt.items()})
            out_imgs.append(im)
            out_tgts.append(tg)
        imgs = torch.stack(out_imgs)
        tgt = {k: torch.stack([t[k] for t in out_tgts]) for k in tgt}
    return imgs, tgt


def loss_fn(model, batch, cfg: Config, seed: int, step: int,
            example_offset: int = 0, apply_fn=None, generators=None):
    """``(loss, metrics)`` of the train-mode forward on one (micro)batch;
    ``apply_fn`` (``models/fused_train``) replaces ``model(x)``;
    ``generators`` as :func:`prepare_batch` takes them. Device stages
    (``utils/profiling.mark``): ``targets`` (:func:`prepare_batch`), then
    ``forward`` (the net and the loss)."""
    mark("targets", batch["image"])
    imgs, tgts = prepare_batch(batch, cfg, seed, step, example_offset,
                               generators)
    mark("forward", imgs)
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


class TrainStep:
    """``step(state, batch, seed) -> metrics`` (:func:`make_train_step`):
    the host part of a step around :meth:`body`, which runs as
    ``program``, a :class:`~tpuseg_torch.infer.graph.CapturedProgram`
    (module docstring). The host part puts the model in train mode (before
    the program reads its context, so a validation's ``model.eval()``
    releases nothing), reseeds the generator bank from (``seed``,
    ``state.step``, the examples' global indices), makes ``hyper`` from
    ``state.opt``, calls the program and then advances ``state.step`` and
    ``state.opt.count``. ``eager(state, batch, seed)`` is the same step with
    the body run eagerly; ``program.mode`` says whether the step is
    captured, ``program.last_run`` how the last call ran. A step is a
    ``step.call`` span (``utils/profiling.py``) around ``step.prepare``
    (the host part) and the program's call; the body's device stages are
    :func:`loss_fn`'s and ``backward`` per microbatch, then
    ``optimizer`` (the global norm, the clipping and AdamW)."""

    def __init__(self, model, cfg: Config, group=None, grad_accum: int = 1):
        self.model, self.cfg = model, cfg
        self.group, self.grad_accum = group, grad_accum
        self.apply_fn = None
        if cfg.train.apply_impl == "fused":
            from tpuseg_torch.models.fused_train import make_fused_train_apply

            self.apply_fn = make_fused_train_apply(model)
        elif cfg.train.apply_impl != "flax":
            raise ValueError(f"unknown TrainConfig.apply_impl "
                             f"{cfg.train.apply_impl!r}")
        self.streams = augment_streams(cfg)
        self.banks = {}
        self.state, self.generators = None, {}
        self.program = CapturedProgram(
            self.body, autograd=True, context=self._context,
            generators=lambda: [g for gens in self.generators.values()
                                for g in gens],
            eager_reason=train_eager_reason(group), name="train.step")

    def _context(self) -> tuple:
        """What the body reads besides its arguments: the model's storage
        and flags, and the optimizer's moments."""
        return (module_state(self.model),
                tuple(t.data_ptr() for t in self.state.opt.moments()))

    def prepare(self, state: TrainState, batch, seed: int) -> tuple:
        """The host part before the body: train mode, the bank reseeded,
        the body's arguments ``(batch, hyper)``."""
        self.model.train()
        b = batch["image"].shape[0]
        if b % self.grad_accum:
            raise ValueError(f"batch {b} does not split into "
                             f"{self.grad_accum} microbatches")
        device = batch["image"].device
        # global index of this rank's first example: the augmentation keys
        # of a single-device run
        offset = 0 if self.group is None else dist.get_rank(self.group) * b
        bank = self.banks.get(device)
        if bank is None:
            bank = self.banks[device] = GeneratorBank(self.streams, device)
        self.state = state
        self.generators = bank.reseed(seed, state.step, offset, b)
        return batch, state.opt.hyper(device)

    def __call__(self, state: TrainState, batch, seed: int):
        return self._step(self.program, state, batch, seed)

    def eager(self, state: TrainState, batch, seed: int):
        return self._step(self.body, state, batch, seed)

    def _step(self, run, state, batch, seed):
        with span("step.call"):
            with span("step.prepare"):
                args = self.prepare(state, batch, seed)
            metrics = run(*args)
        state.opt.count += 1
        state.step += 1
        return metrics

    def body(self, batch, hyper):
        """One optimizer update of ``self.state`` (set by :meth:`prepare`)
        in place; the metrics as 0-d device tensors. Reads no host value
        that changes from step to step."""
        model, opt, k = self.model, self.state.opt, self.grad_accum
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        mb = batch["image"].shape[0] // k
        macc = None
        for j in range(k):
            micro = {n: v[j * mb:(j + 1) * mb] for n, v in batch.items()}
            gens = {s: g[j * mb:(j + 1) * mb]
                    for s, g in self.generators.items()}
            loss, metrics = loss_fn(model, micro, self.cfg, None, None,
                                    apply_fn=self.apply_fn, generators=gens)
            mark("backward", loss)
            loss.backward()
            metrics = {n: v.detach() for n, v in metrics.items()}
            macc = metrics if macc is None else {
                n: macc[n] + metrics[n] for n in macc}
        mark("optimizer", hyper)
        grads = {n: p.grad / k if k > 1 else p.grad
                 for n, p in params.items()}
        if k > 1:
            macc = {n: v / k for n, v in macc.items()}
        if self.group is not None:
            # one all-reduce: the gradients, then the metrics
            flat = group_mean(torch.cat([_flatten(grads), _flatten(macc)]),
                              self.group)
            n = sum(g.numel() for g in grads.values())
            grads, macc = _unflatten(flat[:n], grads), _unflatten(flat[n:],
                                                                 macc)
        gnorm = global_norm(grads.values())
        opt.apply(params, grads, gnorm, hyper)
        for p in params.values():
            p.grad = None
        return dict(macc, grad_norm=gnorm)


def make_train_step(model, cfg: Config, axis_name=None,
                    grad_accum: int = 1) -> TrainStep:
    """Build ``step(state, batch, seed) -> metrics``: one optimizer update of
    ``state`` in place; metrics (0-d device tensors) ``loss``,
    ``peak_loss``, ``fg_loss`` and ``grad_norm`` (before clipping). On one
    CUDA device and without ``axis_name`` the update runs as a captured
    CUDA graph from a batch shape's second step on (:class:`TrainStep`).

    ``seed`` keys the augmentation (the JAX loop's ``train.seed + 1``);
    ``grad_accum`` > 1 splits the batch into that many microbatches whose
    gradients and metrics are averaged before one update, BatchNorm
    statistics carrying from one microbatch to the next.

    ``axis_name``: a process group of data parallelism (the JAX package's
    mesh axis name); ``batch`` is then this rank's slice of the global
    batch, and the model's BatchNorms should share its statistics
    (``train/dp.make_dp_train_step`` sets both up)."""
    # float32 convolutions in full float32: cuDNN would take TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return TrainStep(model, cfg, axis_name, grad_accum)
