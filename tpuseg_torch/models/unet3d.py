"""3D U-Net encoder-decoder with foreground + peak heads (port of
``tpuseg/models/unet3d.py``).

Takes (N, 1, D, H, W) or (N, D, H, W) volumes and returns float32 logits
``{"fg_logits": (N, D, H, W), "peak_logits": (N, D, H, W)}``, computed in
``ModelConfig.compute_dtype``. ``model.train()`` selects train-mode
BatchNorm (batch statistics, running statistics updated in place) and
``model.eval()`` eval-mode BatchNorm, on the same parameters and buffers
(``models/blocks.BatchNorm``); ``models/fused_train.py`` runs the same
modules with the full-resolution convs on the K6 kernel.
``ModelConfig.norm`` ("batch", "group", "none") and ``activation`` ("relu",
"silu", "gelu") select the ConvBlocks' variant (``models/blocks.py``); the
fused applies take the batch-norm/ReLU family alone.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from tpuseg_torch.core import ModelConfig
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.models.blocks import BatchNorm, Conv3d, ConvBlock, Down, Up


class UNet3D(nn.Module):
    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        self.config = config
        self.dtype = resolve(config.compute_dtype)
        kw = dict(norm=config.norm, num_groups=config.num_groups,
                  activation=config.activation)
        f = config.features
        for i in range(len(f) - 1):
            cin = config.in_channels if i == 0 else f[i]
            setattr(self, f"enc{i}", ConvBlock(cin, f[i], **kw))
            setattr(self, f"down{i}", Down(f[i], f[i + 1]))
        self.bottleneck = ConvBlock(
            f[-1] if len(f) > 1 else config.in_channels, f[-1], **kw)
        for i in reversed(range(len(f) - 1)):
            setattr(self, f"up{i}", Up(f[i + 1], f[i], **kw))
        self.head_trunk = ConvBlock(f[0], config.head_features, **kw)
        self.fg_head = Conv3d(config.head_features, 1, 1)
        self.peak_head = Conv3d(config.head_features, 1, 1)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if x.dim() == 4:
            x = x[:, None]
        x = x.to(self.dtype)
        levels = len(self.config.features)
        skips = []
        for i in range(levels - 1):
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
            x = getattr(self, f"down{i}")(x)
        x = self.bottleneck(x)
        for i in reversed(range(levels - 1)):
            x = getattr(self, f"up{i}")(x, skips[i])
        t = self.head_trunk(x)
        return {
            "fg_logits": self.fg_head(t)[:, 0].float(),
            "peak_logits": self.peak_head(t)[:, 0].float(),
        }


@torch.no_grad()
def init_weights(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """Seeded weights (CPU generator): LeCun-normal conv kernels, zero
    biases, BN affine (1, 0) with running statistics drawn around (0, 1)."""
    for m in model.modules():
        if isinstance(m, Conv3d):
            fan_in = math.prod(m.weight.shape[1:])
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            n = m.running_mean.shape
            m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
            m.running_var.copy_(1.0 + 0.2 * torch.rand(n, generator=generator))
    return model


def build_model(config: ModelConfig | None = None, seed: int = 0) -> UNet3D:
    """A U-Net on the CPU with seeded weights (load a checkpoint over them
    with ``model.load_state_dict``)."""
    model = UNet3D(config or ModelConfig())
    return init_weights(model, torch.Generator().manual_seed(seed)).eval()
