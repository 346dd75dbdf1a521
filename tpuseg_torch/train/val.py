"""Train/validation split and periodic validation metrics (port of
``tpuseg/train/val.py``).

* :func:`split_volumes` — the deterministic, seed-keyed hold-out, bit for
  bit: whole volumes when several are given, a z-slab of a single one.
* :func:`make_val_eval` — fixed validation patches (drawn once from a
  seed-keyed sampler, so every evaluation scores the same patches), the
  eval-mode training loss without augmentation, and optionally the
  centre-criterion instance F1 of whole val-volume inference through the
  port's ``make_infer_fn`` (the K1-K3 kernels on a card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpuseg_torch.core import Config
from tpuseg_torch.data.sampler import PatchSampler
from tpuseg_torch.data.synthetic import SyntheticVolume


def split_volumes(
    volumes: Sequence[SyntheticVolume],
    val_fraction: float,
    seed: int = 0,
    min_depth: int = 1,
) -> Tuple[List[SyntheticVolume], List[SyntheticVolume]]:
    """Deterministic (seed-keyed) train/val split.

    len(volumes) >= 2: a seeded permutation holds out
    ``max(1, round(val_fraction * n))`` whole volumes (at least one stays in
    train). One volume: the top ``ceil(val_fraction * D)`` z-planes become the
    val slab, the rest train; annotations go with the slab containing their
    center (coordinates shifted into slab frame).
    """
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(f"val_fraction must be in (0, 1), got {val_fraction}")
    vols = list(volumes)
    if len(vols) >= 2:
        order = np.random.default_rng(
            np.random.SeedSequence(entropy=(seed, 0x51))
        ).permutation(len(vols))
        n_val = min(len(vols) - 1, max(1, round(val_fraction * len(vols))))
        val_idx = set(int(i) for i in order[:n_val])
        train = [v for i, v in enumerate(vols) if i not in val_idx]
        val = [vols[i] for i in sorted(val_idx)]
        return train, val

    (vol,) = vols
    d = vol.image.shape[0]
    d_val = int(np.ceil(val_fraction * d))
    # both slabs must fit at least one patch
    if d_val < min_depth or d - d_val < min_depth:
        raise ValueError(
            f"single-volume split needs >= {min_depth} z planes on each "
            f"side (patch depth); val_fraction={val_fraction} on D={d} gives "
            f"val={d_val}/train={d - d_val}. Use a larger val_fraction, a "
            "deeper volume, or pass whole val volumes.")
    cut = d - d_val

    def slab(z0, z1):
        inside = (vol.centers[:, 0] >= z0) & (vol.centers[:, 0] < z1)
        centers = vol.centers[inside] - np.array([z0, 0, 0], np.float32)
        labels = vol.labels[z0:z1] if vol.labels is not None else None
        return SyntheticVolume(
            image=vol.image[z0:z1],
            labels=labels,
            centers=centers.astype(np.float32),
            half_sizes=vol.half_sizes[inside].astype(np.float32),
        )

    return [slab(0, cut)], [slab(cut, d)]


def make_val_eval(model, cfg: Config, val_volumes: Sequence[SyntheticVolume]):
    """Build ``evaluate() -> {"val_loss": ..., ...}`` for ``model`` on the
    device it sits on. The model runs in eval mode (running statistics)
    and is put back in the mode it was in."""
    from tpuseg_torch.losses import total_loss
    from tpuseg_torch.train.step import prepare_batch

    device = next(model.parameters()).device
    n_batches = max(1, -(-cfg.train.val_patches // cfg.data.batch_size))
    sampler = PatchSampler(
        list(val_volumes),
        patch_size=cfg.data.patch_size,
        batch_size=cfg.data.batch_size,
        max_instances=cfg.data.max_instances,
        seed=cfg.train.seed + 0x5EED,
    )
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in sampler.next_batch().items()}
               for _ in range(n_batches)]
    eval_cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, augment=False))

    infer = None
    if cfg.train.val_f1:
        from tpuseg_torch.eval import center_match_f1
        from tpuseg_torch.infer import make_infer_fn

        # the eager body: its calls are device-bound, and a captured graph
        # would hold its memory pool through the whole run
        infer = make_infer_fn(model, cfg).eager

    def evaluate() -> dict:
        was_training = model.training
        model.eval()
        try:
            losses, fgs, peaks = [], [], []
            with torch.no_grad():
                for b in batches:
                    imgs, tgts = prepare_batch(b, eval_cfg, 0, 0)
                    loss, m = total_loss(model(imgs), tgts, cfg.train)
                    losses.append(float(loss))
                    fgs.append(float(m["fg_loss"]))
                    peaks.append(float(m["peak_loss"]))
            out = {
                "val_loss": float(np.mean(losses)),
                "val_fg_loss": float(np.mean(fgs)),
                "val_peak_loss": float(np.mean(peaks)),
            }
            if infer is not None:
                f1s = []
                for v in val_volumes:
                    labels = infer(torch.from_numpy(v.image).to(device))
                    f1s.append(center_match_f1(labels.cpu().numpy(),
                                               v.centers)["f1"])
                out["val_center_f1"] = float(np.mean(f1s))
        finally:
            model.train(was_training)
        return out

    return evaluate
