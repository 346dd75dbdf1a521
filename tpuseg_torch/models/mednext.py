"""MedNeXt (Roy et al., MICCAI 2023, arXiv:2303.09975; MIC-DKFZ's
``nnunet_mednext/network_architecture/mednextv1``) with the fg and peak
heads of the pipeline.

Takes (B, 1, D, H, W) or (B, D, H, W) volumes, every side a multiple of
16, and returns float32 logits ``{"fg_logits", "peak_logits"}`` (B, D, H,
W), output channels 0 and 1, computed in ``MedNeXtConfig.compute_dtype``
with float32 parameters, as ``UNet3D`` and ``SwinUNETR`` are.

* Stem: a 1x1x1 conv (bias) to ``n_channels``.
* ``Block(C, R)`` = ``x + conv3(GELU(conv2(GN(dw(x)))))``: ``dw`` a k^3
  depthwise conv (pad k // 2, bias), GN a GroupNorm with one group a
  channel (eps 1e-5, affine), conv2 a 1x1x1 conv C -> R C, erf GELU,
  conv3 R C -> C (both with bias).
* ``Down(C, R)``: the block's body with a stride-2 ``dw`` and conv3 to
  2C, plus ``res(x)``, a stride-2 1x1x1 conv C -> 2C (bias).
* ``Up(C, R)``: the block's body with ``dw`` a stride-2 depthwise
  transposed conv (pad k // 2: sides 2S - 1; GN's statistics over them)
  and conv3 to C / 2, plus ``res(x)``, a stride-2 1x1x1 transposed conv C
  -> C / 2 whose odd positions hold its bias alone; the sum is zero-padded
  by one plane at the low end of each axis, to 2S.
* Four levels down and four up from ``n_channels``, ``block_counts`` and
  ``exp_r`` given for the encoder levels, the bottleneck and the decoder
  levels in that order; the decoder adds each skip (``dec_i(skip_i +
  up_i(x))``); the head a 1x1x1 transposed conv (bias). Deep supervision
  and GRN are off.

Routes: every depthwise conv is :func:`tpuseg_torch.ops.dwconv.dwconv`
(D1 on the card, bf16; its twin on the CPU), every GroupNorm is N1's
affine mode (:func:`tpuseg_torch.ops.instnorm.instance_norm_lrelu` with
the GroupNorm's weight and bias, no residual and slope 1), every 1x1x1
conv, strided or transposed, and the head a channel product on the NCDHW
view (``ops.rconv.channel_product``); GELU and the adds are torch ops. The
``nn.Conv3d`` / ``nn.ConvTranspose3d`` / ``nn.GroupNorm`` modules hold the
parameters in MIC-DKFZ's layout.

The module reads the host for nothing, so an inference call captures
whole (``infer/graph.py``). Its forward marks the device stages
``mednext.full`` (stem, level-0 encoder blocks; then the last up block,
the level-0 decoder blocks and the head) and ``mednext.deep`` (levels 1-4)
(``utils/profiling.mark``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.ops.dwconv import dwconv
from tpuseg_torch.ops.instnorm import instance_norm_lrelu
from tpuseg_torch.ops.rconv import channel_product
from tpuseg_torch.utils.profiling import mark

LEVELS = 4                     # downsamplings; block sides are multiples of 16
_LOW_PAD = (1, 0, 1, 0, 1, 0)  # Up's zero plane at the low end of each axis


@dataclass
class MedNeXtConfig:
    """The net's published hyperparameters (MedNeXt-L, kernel 5) and its
    compute dtype; the parameters are float32. Out channel 0 is
    ``fg_logits``, 1 ``peak_logits``."""

    in_channels: int = 1
    out_channels: int = 2
    n_channels: int = 32
    exp_r: Tuple[int, ...] = (3, 4, 8, 8, 8, 8, 8, 4, 3)
    block_counts: Tuple[int, ...] = (3, 4, 8, 8, 8, 8, 8, 4, 3)
    kernel_size: int = 5
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        self.exp_r = tuple(self.exp_r)
        self.block_counts = tuple(self.block_counts)
        if len(self.exp_r) != 2 * LEVELS + 1 or len(self.block_counts) != \
                2 * LEVELS + 1:
            raise ValueError("MedNeXt has nine stages: exp_r and "
                             "block_counts of nine")
        if self.out_channels < 2:
            raise ValueError("MedNeXt here has at least the two output "
                             "channels fg and peak")


class Block(nn.Module):
    """``x + conv3(GELU(conv2(GN(dw(x)))))``; ``Down`` and ``Up`` take its
    body with their own ``dw`` and residual."""

    def __init__(self, ci: int, co: int, r: int, k: int, kind: str = "block"):
        super().__init__()
        self.kind = kind
        if kind == "up":
            self.conv1 = nn.ConvTranspose3d(ci, ci, k, stride=2,
                                            padding=k // 2, groups=ci)
        else:
            self.conv1 = nn.Conv3d(ci, ci, k, stride=2 if kind == "down"
                                   else 1, padding=k // 2, groups=ci)
        self.norm = nn.GroupNorm(ci, ci)
        self.conv2 = nn.Conv3d(ci, r * ci, 1)
        self.conv3 = nn.Conv3d(r * ci, co, 1)
        if kind == "down":
            self.res_conv = nn.Conv3d(ci, co, 1, stride=2)
        elif kind == "up":
            self.res_conv = nn.ConvTranspose3d(ci, co, 1, stride=2)

    def body(self, x):
        y = dwconv(x, self.conv1.weight, self.conv1.bias, stride=1
                   if self.kind == "block" else 2,
                   transposed=self.kind == "up")
        y = instance_norm_lrelu(y, weight=self.norm.weight,
                                bias=self.norm.bias, slope=1.0)
        y = F.gelu(channel_product(y, self.conv2.weight, self.conv2.bias))
        return channel_product(y, self.conv3.weight, self.conv3.bias)

    def forward(self, x):
        y = self.body(x)
        if self.kind == "block":
            return x + y
        w, b = self.res_conv.weight, self.res_conv.bias
        if self.kind == "down":
            return y + channel_product(x[:, :, ::2, ::2, ::2], w, b)
        res = b.to(y.dtype).view(1, -1, 1, 1, 1).expand(y.shape).clone()
        res[:, :, ::2, ::2, ::2] = channel_product(x, w.transpose(0, 1), b)
        return F.pad(y + res, _LOW_PAD)


class MedNeXt(nn.Module):
    def __init__(self, config: MedNeXtConfig = MedNeXtConfig()):
        super().__init__()
        self.config = config
        self.dtype = resolve(config.compute_dtype)
        c, k = config.n_channels, config.kernel_size
        r, n = config.exp_r, config.block_counts
        self.stem = nn.Conv3d(config.in_channels, c, 1)

        def stage(width, i):
            return nn.Sequential(*(Block(width, width, r[i], k)
                                   for _ in range(n[i])))

        self.enc = nn.ModuleList(stage(c * 2 ** i, i) for i in range(LEVELS))
        self.down = nn.ModuleList(
            Block(c * 2 ** i, c * 2 ** (i + 1), r[i + 1], k, "down")
            for i in range(LEVELS))
        self.bottleneck = stage(c * 2 ** LEVELS, LEVELS)
        # decoder level i (LEVELS - 1 down to 0) is stage 2 LEVELS - i
        self.up = nn.ModuleList(
            Block(c * 2 ** (i + 1), c * 2 ** i, r[2 * LEVELS - i], k, "up")
            for i in range(LEVELS))
        self.dec = nn.ModuleList(stage(c * 2 ** i, 2 * LEVELS - i)
                                 for i in range(LEVELS))
        self.head = nn.ConvTranspose3d(c, config.out_channels, 1)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if x.dim() == 4:
            x = x[:, None]
        if any(s % 2 ** LEVELS for s in x.shape[2:]):
            raise ValueError(f"MedNeXt takes blocks whose sides are "
                             f"multiples of {2 ** LEVELS}; got "
                             f"{tuple(x.shape[2:])}")
        x = x.to(self.dtype)
        mark("mednext.full", x)
        y = self.enc[0](channel_product(x, self.stem.weight, self.stem.bias))
        skips = [y]
        mark("mednext.deep", x)
        for i in range(1, LEVELS):
            y = self.enc[i](self.down[i - 1](y))
            skips.append(y)
        y = self.bottleneck(self.down[LEVELS - 1](y))
        for i in reversed(range(1, LEVELS)):
            y = self.dec[i](skips[i] + self.up[i](y))
        mark("mednext.full", x)
        y = self.dec[0](skips[0] + self.up[0](y))
        out = channel_product(y, self.head.weight.transpose(0, 1),
                              self.head.bias)
        return {"fg_logits": out[:, 0].float(),
                "peak_logits": out[:, 1].float()}


@torch.no_grad()
def init_mednext(model: MedNeXt, generator: torch.Generator) -> MedNeXt:
    """Seeded weights (CPU generator): conv and transposed-conv kernels
    normal with std 1 / sqrt(:func:`fan_in`), biases 0, GroupNorm affines
    (1, 0)."""
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        if isinstance(module, nn.GroupNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in(module)))
    return model


def fan_in(module) -> int:
    """A conv's input channels a group times its taps (a depthwise kernel:
    its k^3 taps; a 1x1x1 transposed conv: its input channels)."""
    w = module.weight
    if isinstance(module, nn.ConvTranspose3d):
        return w.shape[0] // module.groups * math.prod(w.shape[2:])
    return math.prod(w.shape[1:])


def build_mednext(config: MedNeXtConfig | None = None, seed: int = 0
                  ) -> MedNeXt:
    """A MedNeXt on the CPU with seeded weights (load a state dict over
    them with ``model.load_state_dict``)."""
    model = MedNeXt(config or MedNeXtConfig())
    return init_mednext(model, torch.Generator().manual_seed(seed)).eval()
