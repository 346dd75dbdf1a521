"""Peak/centre-response loss (port of ``tpuseg/losses/peak.py``): MSE of
sigmoid(logits) against the gaussian peak target, positives up-weighted by
``1 + pos_weight * target``."""

from __future__ import annotations

import torch


def peak_loss(peak_logits: torch.Tensor, peak_target: torch.Tensor,
              pos_weight: float = 10.0) -> torch.Tensor:
    """Per-example loss: (B, D, H, W) maps -> (B,) float32."""
    dims = tuple(range(1, peak_logits.dim()))
    pred = torch.sigmoid(peak_logits.float())
    target = peak_target.float()
    w = 1.0 + pos_weight * target
    return (w * (pred - target) ** 2).sum(dims) / w.sum(dims)
