"""Box-derived foreground loss (port of ``tpuseg/losses/box_fg.py``):
weighted BCE plus soft Dice on the box pseudo-labels; the uncertainty ring
around each box has weight 0 and adds no gradient."""

from __future__ import annotations

import torch


def _bce_with_logits(logits, target):
    # numerically stable: max(x,0) - x*t + log1p(exp(-|x|))
    return (torch.clamp(logits, min=0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def fg_loss(fg_logits: torch.Tensor, fg_target: torch.Tensor,
            fg_weight: torch.Tensor, dice_weight: float = 0.5,
            eps: float = 1.0) -> torch.Tensor:
    """Per-example loss: (B, D, H, W) maps -> (B,) float32."""
    dims = tuple(range(1, fg_logits.dim()))
    logits = fg_logits.float()
    target = fg_target.float()
    w = fg_weight.float()
    bce = ((w * _bce_with_logits(logits, target)).sum(dims)
           / torch.clamp(w.sum(dims), min=1.0))
    prob = torch.sigmoid(logits)
    inter = (w * prob * target).sum(dims)
    denom = (w * prob).sum(dims) + (w * target).sum(dims)
    dice = 1.0 - (2.0 * inter + eps) / (denom + eps)
    return bce + dice_weight * dice
