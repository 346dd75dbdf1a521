"""Building blocks of the 3D U-Net (port of ``tpuseg/models/blocks.py``).

NCDHW tensors. Parameters are float32 and cast to the compute dtype at use;
every op rounds where the JAX package's does:

* ``Conv3d`` convolves in the compute dtype and adds its bias afterwards, in
  that dtype (``tpuseg/models/conv3d.Conv3D``);
* ``EvalBatchNorm`` folds the running statistics to a per-channel affine in
  float32 and applies it in the compute dtype (``blocks.py:62-67``);
* ``Up`` is nearest x2, a (0, 1) pad on each axis (XLA's SAME for an even
  kernel), then the k=2 conv (``ckpt/torch_mirror.py:68-71``).

Module and parameter names are those of ``tpuseg/ckpt/torch_mirror.py``, so
the ``.pth`` files that ``tpuseg.cli.export`` writes load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computed in the input's dtype, bias added after the
    convolution in that dtype."""

    def forward(self, x):
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)
        return y


class EvalBatchNorm(nn.Module):
    """Inference BatchNorm: ``x * s + b`` in the input's dtype with
    ``s = rsqrt(var + eps) * weight`` and ``b = bias - mean * s`` folded in
    float32. State names are ``nn.BatchNorm3d``'s."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        s = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * s
        return (x * s.to(x.dtype).view(1, -1, 1, 1, 1)
                + b.to(x.dtype).view(1, -1, 1, 1, 1))


class ConvBlock(nn.Module):
    """(Conv3x3x3 -> eval BN -> ReLU) twice."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv0 = Conv3d(cin, cout, 3, padding=1, bias=False)
        self.norm0 = EvalBatchNorm(cout)
        self.conv1 = Conv3d(cout, cout, 3, padding=1, bias=False)
        self.norm1 = EvalBatchNorm(cout)

    def forward(self, x):
        x = F.relu(self.norm0(self.conv0(x)))
        return F.relu(self.norm1(self.conv1(x)))


class Down(nn.Module):
    """Stride-2 k=2 conv downsample (VALID)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.down = Conv3d(cin, cout, 2, stride=2)

    def forward(self, x):
        return self.down(x)


class Up(nn.Module):
    """Upsample x2 -> k=2 conv -> concat skip -> ConvBlock."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up_conv = Conv3d(cin, cout, 2)
        self.block = ConvBlock(2 * cout, cout)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = F.pad(x, (0, 1, 0, 1, 0, 1))
        x = self.up_conv(x)
        return self.block(torch.cat([x, skip.to(x.dtype)], dim=1))
