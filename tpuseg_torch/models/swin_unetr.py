"""SwinUNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI's
``monai/networks/nets/swin_unetr.py``) with the fg and peak heads of the
pipeline.

Takes (B, 1, D, H, W) or (B, D, H, W) volumes, every side a multiple of
32, and returns float32 logits ``{"fg_logits", "peak_logits"}`` (B, D, H,
W), output channels 0 and 1, computed in ``SwinUNETRConfig.compute_dtype``
with float32 parameters, as ``UNet3D`` is.

* Swin encoder (channels last): a k=2 stride-2 patch-embedding conv, then
  per stage i at ``feature_size * 2^i`` channels ``depths[i]`` Swin blocks
  ``z = x + WA(LN(x))``, ``x = z + MLP(LN(z))`` (MLP: linear to 4C, erf
  GELU, linear back), and a patch merging (the 8 parity slices in
  ``itertools.product`` order over (z, y, x), LN, a bias-free linear to
  2C). WA zero-pads the normed tokens at the high end to whole windows;
  odd blocks roll the grid by -shift, attend within each window with the
  learned relative-position bias and Swin's region mask, and roll back
  (:func:`tpuseg_torch.ops.window_attn.window_attention`: the W1 kernel on
  the card, which computes bf16 alone and refuses float32; its twin on the
  CPU). Where a side of the token grid is at most the window, the window
  shrinks to that side and its shift is 0.
  The hidden outputs are the non-affine LayerNorms of the embedding and of
  each stage's merged output.
* CNN: ``ResBlock(ci, co)`` = ``lrelu(IN(conv2(lrelu(IN(conv1(x))))) +
  r)`` (3x3x3 convs), ``r = IN(conv3(x))`` (1x1x1) where ci != co and
  ``x`` otherwise (convs without bias, non-affine InstanceNorm over each
  (n, c) plane with the biased variance and eps 1e-5, LeakyReLU 0.01).
  The 3x3x3 convs are :func:`tpuseg_torch.ops.rconv.rconv`: on the card
  the R1 kernel, NCDHW in and out, bf16 operands, float32 sums rounded
  once; on the CPU its twin. conv3 and the head are channel products on
  the NCDHW view (``ops.rconv.channel_product``). The ``Conv3d`` modules
  hold the parameters.
  Each ``lrelu(IN(.) + r)`` is one call of
  :func:`tpuseg_torch.ops.instnorm.instance_norm_lrelu`: on the card the N1
  kernel pair, float32 statistics and the normalized, added and activated
  value computed in float32 and rounded to the compute dtype once; on the
  CPU its twin, ``torch.instance_norm``, the add and ``F.leaky_relu`` each
  rounding on its own. Inference only: the wrapper refuses autograd.
  ``Up(ci, co)`` = ``ResBlock(2co, co)(cat[convT_k2s2(x), skip])``. Encoders
  on the input and on hidden outputs 0-2, a bottleneck on hidden output 4,
  five Ups (the first takes hidden output 3 as its skip) and a 1x1x1 head.

The module reads the host for nothing, so an inference call captures
whole (``infer/graph.py``). Its forward marks the device stages
``swin.transformer`` (embedding, stages, merges, hidden-output norms) and
``swin.cnn`` (encoders, up path, head) (``utils/profiling.mark``).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.models.blocks import Conv3d
from tpuseg_torch.ops.instnorm import instance_norm_lrelu
from tpuseg_torch.ops.rconv import channel_product, rconv
from tpuseg_torch.ops.window_attn import WINDOW, window_attention
from tpuseg_torch.utils.profiling import mark

LN_EPS = 1e-5
PATCH = 2                       # the patch embedding's side
_PARITIES = tuple(itertools.product((0, 1), repeat=3))


@dataclass
class SwinUNETRConfig:
    """The net's published hyperparameters (feature 48, depths 2/2/2/2,
    heads 3/6/12/24: head dim 16 at every stage, MLP ratio 4) and its
    compute dtype; the window (``WINDOW``, 7) and the patch (``PATCH``, 2)
    are constants, and the parameters are float32. Out channel 0 is
    ``fg_logits``, 1 ``peak_logits``."""

    in_channels: int = 1
    out_channels: int = 2
    feature_size: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    mlp_ratio: float = 4.0
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        self.depths = tuple(self.depths)
        self.num_heads = tuple(self.num_heads)
        if len(self.depths) != 4 or len(self.num_heads) != 4:
            raise ValueError("SwinUNETR has four stages: depths and "
                             "num_heads of four")
        if self.out_channels < 2:
            raise ValueError("SwinUNETR here has at least the two output "
                             "channels fg and peak")


def window_and_shift(grid, window: int, shifted: bool) -> tuple:
    """The window and the shift a token grid takes: a side at most the
    window shrinks the window to it and takes no shift."""
    win = tuple(min(window, s) for s in grid)
    shift = tuple(window // 2 if shifted and s > window else 0
                  for s in grid)
    return win, shift


class Linear(nn.Linear):
    """``nn.Linear`` computed in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over channels, affine in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.bias_table = nn.Parameter(torch.zeros((2 * WINDOW - 1) ** 3,
                                                   heads))

    def forward(self, windows, win, shift, grid):
        bw, n, c = windows.shape
        qkv = self.qkv(windows).view(bw, n, 3, self.heads, c // self.heads)
        return self.proj(window_attention(qkv, self.bias_table, win, shift,
                                          grid))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 shifted: bool):
        super().__init__()
        self.shifted = shifted
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.ModuleDict({"fc1": Linear(dim, hidden),
                                  "fc2": Linear(hidden, dim)})

    def _attend(self, x):
        b, d, h, w, c = x.shape
        win, shift = window_and_shift((d, h, w), WINDOW, self.shifted)
        grid = tuple(-(-s // k) for s, k in zip((d, h, w), win))
        pd, ph, pw = (g * k - s for g, k, s in zip(grid, win, (d, h, w)))
        y = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph, 0, pd))
        if any(shift):
            y = torch.roll(y, tuple(-s for s in shift), (1, 2, 3))
        (gd, gh, gw), (wd, wh, ww) = grid, win
        y = (y.view(b, gd, wd, gh, wh, gw, ww, c)
             .permute(0, 1, 3, 5, 2, 4, 6, 7)
             .reshape(b * gd * gh * gw, wd * wh * ww, c))
        y = self.attn(y, win, shift, grid)
        y = (y.view(b, gd, gh, gw, wd, wh, ww, c)
             .permute(0, 1, 4, 2, 5, 3, 6, 7)
             .reshape(b, gd * wd, gh * wh, gw * ww, c))
        if any(shift):
            y = torch.roll(y, shift, (1, 2, 3))
        return y[:, :d, :h, :w]

    def forward(self, x):
        x = x + self._attend(x)
        m = self.mlp
        return x + m["fc2"](F.gelu(m["fc1"](self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in _PARITIES], -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, mlp_ratio, shifted=j % 2 == 1)
            for j in range(depth))
        self.merge = PatchMerging(dim)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.merge(x)


class ResBlock(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv1 = Conv3d(ci, co, 3, padding=1, bias=False)
        self.conv2 = Conv3d(co, co, 3, padding=1, bias=False)
        self.conv3 = Conv3d(ci, co, 1, bias=False) if ci != co else None

    def forward(self, x):
        y = rconv(instance_norm_lrelu(rconv(x, self.conv1.weight)),
                  self.conv2.weight)
        if self.conv3 is None:
            return instance_norm_lrelu(y, x)
        return instance_norm_lrelu(
            y, channel_product(x, self.conv3.weight), norm_r=True)


class Up(nn.Module):
    """``ResBlock(2co, co)(cat[convT(x), skip])``; the k=2 stride-2
    transposed conv has no overlap, so it is one product over channels a
    voxel (no atomics, the same sums on every call)."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.up = nn.Parameter(torch.zeros(ci, co, 2, 2, 2))
        self.block = ResBlock(2 * co, co)

    def forward(self, x, skip):
        n, ci, d, h, w = x.shape
        co = self.up.shape[1]
        y = torch.matmul(x.permute(0, 2, 3, 4, 1),
                         self.up.to(x.dtype).reshape(ci, co * 8))
        y = (y.view(n, d, h, w, co, 2, 2, 2).permute(0, 4, 1, 5, 2, 6, 3, 7)
             .reshape(n, co, 2 * d, 2 * h, 2 * w))
        return self.block(torch.cat([y, skip], 1))


def _hidden(x):
    """A hidden output: the non-affine LayerNorm over channels, to NCDHW."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS).permute(
        0, 4, 1, 2, 3).contiguous()


class SwinUNETR(nn.Module):
    def __init__(self, config: SwinUNETRConfig = SwinUNETRConfig()):
        super().__init__()
        self.config = config
        self.dtype = resolve(config.compute_dtype)
        fs = config.feature_size
        self.patch_embed = Conv3d(config.in_channels, fs, PATCH, stride=PATCH)
        self.layers = nn.ModuleList(
            SwinStage(fs * 2 ** i, config.depths[i], config.num_heads[i],
                      config.mlp_ratio) for i in range(4))
        self.enc0 = ResBlock(config.in_channels, fs)
        self.enc1 = ResBlock(fs, fs)
        self.enc2 = ResBlock(2 * fs, 2 * fs)
        self.enc3 = ResBlock(4 * fs, 4 * fs)
        self.bottleneck = ResBlock(16 * fs, 16 * fs)
        self.dec4 = Up(16 * fs, 8 * fs)
        self.dec3 = Up(8 * fs, 4 * fs)
        self.dec2 = Up(4 * fs, 2 * fs)
        self.dec1 = Up(2 * fs, fs)
        self.dec0 = Up(fs, fs)
        self.head = Conv3d(fs, config.out_channels, 1)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if x.dim() == 4:
            x = x[:, None]
        if any(s % 32 for s in x.shape[2:]):
            raise ValueError(f"SwinUNETR takes blocks whose sides are "
                             f"multiples of 32; got {tuple(x.shape[2:])}")
        x = x.to(self.dtype)
        mark("swin.transformer", x)
        t = self.patch_embed(x).permute(0, 2, 3, 4, 1)
        hidden = [_hidden(t)]
        for stage in self.layers:
            t = stage(t)
            hidden.append(_hidden(t))
        mark("swin.cnn", x)
        e0 = self.enc0(x)
        e1 = self.enc1(hidden[0])
        e2 = self.enc2(hidden[1])
        e3 = self.enc3(hidden[2])
        y = self.dec4(self.bottleneck(hidden[4]), hidden[3])
        y = self.dec0(self.dec1(self.dec2(self.dec3(y, e3), e2), e1), e0)
        out = channel_product(y, self.head.weight, self.head.bias)
        return {"fg_logits": out[:, 0].float(),
                "peak_logits": out[:, 1].float()}


@torch.no_grad()
def init_swin_unetr(model: SwinUNETR, generator: torch.Generator
                    ) -> SwinUNETR:
    """Seeded weights (CPU generator): linears and relative-position tables
    normal with std 0.02 (Swin's truncated normal without the cut), conv
    and transposed-conv kernels LeCun normal, biases 0, LayerNorm affines
    (1, 0)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                      (LayerNorm,)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif p.dim() == 2:
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))
        else:
            fan_in = (p.shape[0] if leaf == "up"
                      else math.prod(p.shape[1:]))
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
    return model


def build_swin_unetr(config: SwinUNETRConfig | None = None, seed: int = 0
                     ) -> SwinUNETR:
    """A SwinUNETR on the CPU with seeded weights (load a state dict over
    them with ``model.load_state_dict``)."""
    model = SwinUNETR(config or SwinUNETRConfig())
    return init_swin_unetr(model, torch.Generator().manual_seed(seed)).eval()
