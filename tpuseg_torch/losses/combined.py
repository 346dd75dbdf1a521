"""Combined weakly-supervised objective (port of
``tpuseg/losses/combined.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpuseg_torch.core import TrainConfig
from tpuseg_torch.losses.box_fg import fg_loss
from tpuseg_torch.losses.peak import peak_loss


def total_loss(outputs: Dict[str, torch.Tensor],
               targets: Dict[str, torch.Tensor],
               cfg: TrainConfig = TrainConfig()
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-example losses averaged over the batch (the normalization that
    makes the objective decompose over data-parallel shards)."""
    lp = peak_loss(outputs["peak_logits"], targets["peak"]).mean()
    lf = fg_loss(outputs["fg_logits"], targets["fg"], targets["fg_weight"],
                 dice_weight=cfg.dice_weight).mean()
    loss = cfg.peak_loss_weight * lp + cfg.fg_loss_weight * lf
    return loss, {"loss": loss, "peak_loss": lp, "fg_loss": lf}
