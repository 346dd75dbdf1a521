"""Weakly-supervised training loop (port of ``tpuseg/train/loop.py``), with

* JSONL metrics including Mvox/s;
* periodic validation and the best-val-loss checkpoint under
  ``<ckpt_dir>/best``;
* checkpoints carrying parameters, optimizer state, BatchNorm statistics,
  the step, the sampler state and the best val loss, for exact resume.

One process trains on the one device it is given; on a card its step is
a captured CUDA graph from the second step on (``train/step.TrainStep``),
and the loop reads the step's metrics only every ``log_every`` steps.
Validation, checkpoints and resume keep the graph. Under a multi-process
runtime (``parallel/multihost.py``, more than one process) it trains
data-parallel, as the JAX loop does when it sees several devices
(``train/dp.py``): each process draws the same global batch and steps on
its slice, on its own device; ``data.batch_size`` must divide by the
process count. Rank 0 alone writes the checkpoints and the JSONL (the other
ranks wait at a barrier after each save); ``resume`` restores every rank
from the same directory; validation runs on every rank's replica and rank
0 logs it; Mvox/s counts the global batch.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpuseg_torch.ckpt.manager import CheckpointManager
from tpuseg_torch.core import Config
from tpuseg_torch.data.sampler import PatchSampler
from tpuseg_torch.data.synthetic import SyntheticVolume
from tpuseg_torch.models import build_model
from tpuseg_torch.models.blocks import BatchNorm
from tpuseg_torch.parallel.multihost import (barrier, is_multiprocess,
                                             process_count, process_device,
                                             process_index)
from tpuseg_torch.train.step import create_train_state, make_train_step
from tpuseg_torch.utils.logging import MetricsLogger


def _uploader(device: torch.device):
    """Host batch -> device batch: pinned memory and non-blocking copies on a
    card, so the copy overlaps the running step."""
    if device.type == "cpu":
        return lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    return lambda b: {k: torch.from_numpy(v).pin_memory().to(
        device, non_blocking=True) for k, v in b.items()}


class _SyncFeed:
    """The in-loop sampling of ``train.prefetch_depth = 0``."""

    def __init__(self, sampler, put):
        self.sampler = sampler
        self.put = put

    def next(self):
        return self.put(self.sampler.next_batch())

    def state_dict(self):
        return self.sampler.state_dict()

    def close(self):
        pass


def train(
    cfg: Config,
    volumes: Sequence[SyntheticVolume],
    log_path: Optional[str] = None,
    resume: bool = False,
    val_volumes: Optional[Sequence[SyntheticVolume]] = None,
    device="cuda",
):
    """Returns (final TrainState, list of metric dicts).

    Validation: pass ``val_volumes``, or set ``cfg.train.val_fraction`` > 0
    to hold out part of ``volumes`` (``train/val.split_volumes``; a resume
    re-derives the same split). Val metrics land in the same JSONL/history
    stream as ``val_*`` keys. Under a multi-process runtime every process
    calls ``train`` with the same arguments (see the module docstring)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available")
    dp = is_multiprocess()
    if dp:
        if cfg.data.batch_size % process_count():
            raise ValueError(
                f"data.batch_size {cfg.data.batch_size} does not divide over "
                f"{process_count()} processes")
        device = process_device(device)
    writer = process_index() == 0
    model = build_model(cfg.model, seed=cfg.train.seed)
    for m in model.modules():      # flax's initial statistics
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    model.to(device).train()
    state = create_train_state(model, cfg)

    if val_volumes is None and cfg.train.val_fraction > 0:
        from tpuseg_torch.train.val import split_volumes

        volumes, val_volumes = split_volumes(
            volumes, cfg.train.val_fraction, cfg.train.seed,
            min_depth=cfg.data.patch_size[0])
    val_eval = None
    if val_volumes:
        from tpuseg_torch.train.val import make_val_eval

        val_eval = make_val_eval(model, cfg, val_volumes)

    sampler = PatchSampler(
        volumes,
        patch_size=cfg.data.patch_size,
        batch_size=cfg.data.batch_size,
        max_instances=cfg.data.max_instances,
        seed=cfg.train.seed,
    )
    mgr = CheckpointManager(cfg.train.ckpt_dir, keep=cfg.train.keep_ckpts)
    best_mgr = None
    if val_eval is not None and cfg.train.keep_best:
        best_mgr = CheckpointManager(
            os.path.join(cfg.train.ckpt_dir, "best"), keep=1)
    best_val = float("inf")

    start_step = 0
    if resume and mgr.latest_step() is not None:
        params, opt_state, meta, batch_stats = mgr.restore()
        model.load_state_dict({**params, **(batch_stats or {})})
        state.opt.load_state_dict(opt_state)
        state.step = start_step = int(meta["step"])
        sampler.load_state_dict(meta["sampler"])
        best_val = float(meta.get("best_val", best_val))

    upload = _uploader(device)
    if dp:
        from tpuseg_torch.train.dp import (local_examples, make_data_mesh,
                                           make_dp_train_step)

        mesh = make_data_mesh(cfg.train.data_axis, device)
        step_fn = make_dp_train_step(model, cfg, mesh)

        def put(b):
            return upload(local_examples(b, mesh))
    else:
        step_fn = make_train_step(model, cfg, grad_accum=cfg.train.grad_accum)
        put = upload
    logger = MetricsLogger(log_path if writer else None, echo=False)
    step_seed = cfg.train.seed + 1
    voxels_per_batch = cfg.data.batch_size * int(np.prod(cfg.data.patch_size))

    # background sampling + upload; state_dict() counts CONSUMED batches
    if cfg.train.prefetch_depth > 0:
        from tpuseg_torch.data.prefetch import BatchPrefetcher

        feed = BatchPrefetcher(sampler, put, depth=cfg.train.prefetch_depth)
    else:
        feed = _SyncFeed(sampler, put)

    def save(manager, step, meta):
        if writer:
            manager.save(step, state.params(), state.opt.state_dict(),
                         meta={"step": step, "config": cfg.to_dict(), **meta},
                         batch_stats=state.batch_stats())
        barrier()

    history = []
    try:
        t_last = time.perf_counter()
        for step in range(start_step, cfg.train.total_steps):
            batch = feed.next()
            metrics = step_fn(state, batch, step_seed)
            done = step + 1
            if done % cfg.train.log_every == 0 or done == cfg.train.total_steps:
                metrics = {k: float(v) for k, v in metrics.items()}  # syncs
                now = time.perf_counter()
                dt = now - t_last
                t_last = now
                mvox_s = voxels_per_batch * cfg.train.log_every / dt / 1e6
                logger.log(done, metrics, mvox_per_s=round(mvox_s, 3))
                history.append({"step": done, **metrics, "mvox_per_s": mvox_s})
            if val_eval is not None and (
                    done % cfg.train.val_every == 0
                    or done == cfg.train.total_steps):
                vm = val_eval()
                logger.log(done, vm)
                history.append({"step": done, **vm})
                if best_mgr is not None and vm["val_loss"] < best_val:
                    best_val = vm["val_loss"]
                    save(best_mgr, done, vm)
                t_last = time.perf_counter()  # don't bill val time as train
            if done % cfg.train.ckpt_every == 0 or done == cfg.train.total_steps:
                save(mgr, done, {"sampler": feed.state_dict(),
                                 "best_val": best_val})
    finally:
        feed.close()
        logger.close()
    return state, history
