"""Building blocks of the 3D U-Net (port of ``tpuseg/models/blocks.py``).

NCDHW tensors. Parameters are float32 and cast to the compute dtype at use;
every op rounds where the JAX package's does:

* ``Conv3d`` convolves in the compute dtype and adds its bias afterwards, in
  that dtype (``tpuseg/models/conv3d.Conv3D``);
* ``BatchNorm`` in eval mode folds the running statistics to a per-channel
  affine in float32 and applies it in the compute dtype (``EvalBatchNorm``,
  ``blocks.py:62-67``); in train mode it normalizes with float32 batch
  statistics reduced from the compute-dtype tensor, applies the folded
  affine in float32 arithmetic and rounds once to the compute dtype, so the
  backward's per-channel reductions accumulate in float32
  (``TrainBatchNorm``, ``blocks.py:111-131``); on a process group of data
  parallelism the statistics are the means over the ranks
  (``lax.pmean``), differentiably (:class:`GroupMean`);
* ``Up`` is nearest x2, a (0, 1) pad on each axis (XLA's SAME for an even
  kernel), then the k=2 conv (``ckpt/torch_mirror.py:68-71``).

Module and parameter names are those of ``tpuseg/ckpt/torch_mirror.py``, so
the ``.pth`` files that ``tpuseg.cli.export`` writes load as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.ops.convblock import fold_bn_affine
from tpuseg_torch.parallel.collectives import group_mean


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computed in the input's dtype, bias added after the
    convolution in that dtype."""

    def forward(self, x):
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)
        return y


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1, 1)


def eval_batch_norm(x, weight, bias, running_mean, running_var,
                    eps: float = 1e-5):
    """``EvalBatchNorm``: ``x * s + b`` in x's dtype with
    ``s = rsqrt(var + eps) * weight`` and ``b = bias - mean * s`` folded in
    float32."""
    s, b = fold_bn_affine(weight, bias, running_mean, running_var, eps)
    return x * _channel(s.to(x.dtype)) + _channel(b.to(x.dtype))


class GroupMean(torch.autograd.Function):
    """``lax.pmean`` over a process group as a differentiable function: the
    forward is the mean of ``x`` over the ranks, and so is the backward of
    the cotangents (each rank's input feeds every rank's output by 1/N).
    A bare ``all_reduce`` has no backward, so each rank's input gradients
    would miss the other ranks' terms."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group_mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return group_mean(g, ctx.group), None


def train_batch_norm(x, weight, bias, running_mean, running_var,
                     momentum: float = 0.9, eps: float = 1e-5, group=None):
    """``TrainBatchNorm``: normalize (N, C, D, H, W) ``x`` by its float32
    batch statistics — the mean and the biased variance
    ``max(E[x^2] - mean^2, 0)`` over (N, D, H, W) — and update the running
    statistics in place by the EMA ``momentum * old + (1 - momentum) *
    batch`` (flax's convention; ``nn.BatchNorm3d`` keeps an unbiased
    variance under the opposite momentum). The folded affine is applied in
    float32 and rounded once to x's dtype.

    ``group``: a process group of data parallelism; with more than one rank
    the statistics ``(mean, E[x^2])`` are their means over the ranks
    (:class:`GroupMean`), those of the global batch."""
    dims = (0, 2, 3, 4)
    xf = x.float()
    mean = xf.mean(dims)
    mean2 = torch.square(xf).mean(dims)
    if group is not None and dist.get_world_size(group) > 1:
        mean, mean2 = GroupMean.apply(torch.stack([mean, mean2]), group)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean
                           + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    a = weight.float() * torch.rsqrt(var + eps)
    b = bias.float() - mean * a
    return (xf * _channel(a) + _channel(b)).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm with ``nn.BatchNorm3d``'s state names: train mode runs
    :func:`train_batch_norm`, eval mode :func:`eval_batch_norm`, on the same
    parameters and running statistics. ``group``: the process group whose
    ranks share the train-mode statistics (``train/dp.py`` sets it)."""

    momentum = 0.9          # the JAX package's ConvBlock sets these two
    eps = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            return train_batch_norm(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.momentum, self.eps, self.group)
        return eval_batch_norm(x, self.weight, self.bias, self.running_mean,
                               self.running_var, self.eps)


class ConvBlock(nn.Module):
    """(Conv3x3x3 -> BN -> ReLU) twice."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv0 = Conv3d(cin, cout, 3, padding=1, bias=False)
        self.norm0 = BatchNorm(cout)
        self.conv1 = Conv3d(cout, cout, 3, padding=1, bias=False)
        self.norm1 = BatchNorm(cout)

    def forward(self, x):
        x = F.relu(self.norm0(self.conv0(x)))
        return F.relu(self.norm1(self.conv1(x)))


def head_logits(conv: Conv3d, t: torch.Tensor) -> torch.Tensor:
    """A 1x1x1 head of the fused applies: the float32-accumulated channel
    contraction of the compute-dtype trunk ``t`` (N, C, D, H, W) with the
    head kernel rounded to that dtype, plus a float32 bias -> (N, D, H, W)
    float32 (``tpuseg/models/fused_eval.py:163-168``) — not the module
    path's compute-dtype bias add."""
    k = conv.weight.reshape(-1).to(t.dtype).float()
    return torch.einsum("ncdhw,c->ndhw", t.float(), k) + conv.bias.float()


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

    def up(self, x):
        """The k=2 conv of the nearest-x2 upsampled ``x``."""
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.up_conv(F.pad(x, (0, 1, 0, 1, 0, 1)))

    def forward(self, x, skip):
        x = self.up(x)
        return self.block(torch.cat([x, skip.to(x.dtype)], dim=1))
