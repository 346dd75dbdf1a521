"""Weakly-supervised losses (port of ``tpuseg/losses``): per-example peak
MSE and box-derived fg loss, averaged over the batch."""

from tpuseg_torch.losses.box_fg import fg_loss
from tpuseg_torch.losses.combined import total_loss
from tpuseg_torch.losses.peak import peak_loss

__all__ = ["fg_loss", "peak_loss", "total_loss"]
