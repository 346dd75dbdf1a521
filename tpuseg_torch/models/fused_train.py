"""Train-mode U-Net forward with the full-resolution convs on the K6 kernel
(port of ``tpuseg/models/fused_train.py``).

``make_fused_train_apply(model)`` returns ``apply_fn(x) -> out`` with the
results contract of ``model(x)`` in train mode — float32 fg/peak logits,
the running statistics of every BatchNorm updated in place:

* the six full-resolution 3x3x3 convs (enc0, up0.block, head_trunk) run as
  ``ops.convtrain.conv3x3`` (K6 forward and dx, library dw), each followed
  by the block's train-mode BatchNorm and a ReLU;
* the mid net (down0 .. up1, up0.up_conv) runs the model's own modules;
* the 1x1x1 heads are a float32-accumulated channel contraction of the
  compute-dtype trunk plus a float32 bias (``fused_train.py:182-187``),
  not the module path's compute-dtype bias add.

The model must be in train mode (``model.train()``). There is no layout
change and no shape guard: the kernel takes every (N, D, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.models.blocks import ConvBlock, head_logits
from tpuseg_torch.models.unet3d import UNet3D
from tpuseg_torch.ops.convtrain import conv3x3


def fused_train_supported(config) -> bool:
    """The flagship family the fused train apply covers: batch norm, ReLU,
    features[0] = head_features = 32. The kernel takes every batch and
    patch shape (the JAX package's lane-packing guard is not ported)."""
    return (config.norm == "batch" and config.activation == "relu"
            and config.features[0] == 32 and config.head_features == 32)


def make_fused_train_apply(model: UNet3D):
    """Build ``apply_fn(x)`` for a U-Net of the flagship family
    (:func:`fused_train_supported`); raises ValueError otherwise."""
    cfg = model.config
    if not fused_train_supported(cfg):
        raise ValueError(f"fused train apply requires the flagship family; "
                         f"got {cfg}")
    dtype = model.dtype
    levels = len(cfg.features)

    def fused_block(block: ConvBlock, x):
        """(conv3x3 -> BN(train) -> ReLU) x2 with the convs on K6."""
        y = conv3x3(x, block.conv0.weight, cfg.compute_dtype)
        y = F.relu(block.norm0(y))
        y = conv3x3(y, block.conv1.weight, cfg.compute_dtype)
        return F.relu(block.norm1(y))

    def apply_fn(x):
        if x.dim() == 4:
            x = x[:, None]
        if x.shape[1] != cfg.in_channels:
            raise ValueError(f"fused train apply: {x.shape[1]} input "
                             f"channels, model takes {cfg.in_channels}")
        skip0 = fused_block(model.enc0, x.to(dtype))
        h = skip0
        skips = []
        for i in range(1, levels - 1):
            h = getattr(model, f"enc{i}")(getattr(model, f"down{i - 1}")(h))
            skips.append(h)
        h = model.bottleneck(getattr(model, f"down{levels - 2}")(h))
        for i in reversed(range(1, levels - 1)):
            h = getattr(model, f"up{i}")(h, skips[i - 1])
        t = torch.cat([model.up0.up(h), skip0], dim=1)
        t = fused_block(model.up0.block, t)
        t = fused_block(model.head_trunk, t)
        return {"fg_logits": head_logits(model.fg_head, t),
                "peak_logits": head_logits(model.peak_head, t)}

    return apply_fn
