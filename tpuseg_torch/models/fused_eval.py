"""Eval-mode U-Net forward with the full-resolution ConvBlocks on the fused
ConvBlock kernel (K4; port of ``tpuseg/models/fused_eval.py``).

``make_fused_apply(model)`` returns ``apply_fn(x) -> out`` with the eval
contract of ``model(x)`` — float32 fg/peak logits (N, D, H, W) — that the
tile sweep (``infer/tiles.py``) uses in the model's place:

* enc0, up0.block and head_trunk (the three 32-channel full-resolution
  ConvBlocks) run as ``ops.convblock.fused_convblock``, their BatchNorm
  running statistics folded to float32 affines;
* in bf16, each Up level's upsample, k=2 conv, bias and skip concatenation
  run as ``ops.upconv.upsample_conv_cat`` on the coarse tensor, with the
  module path's products and rounding points; in float32 they run
  ``Up.up`` and ``torch.cat`` (the route is the model's dtype);
* the rest of the mid net (down0 .. bottleneck, the ConvBlocks of up1 ..)
  runs the model's own modules in eval mode;
* the 1x1x1 heads are ``models.blocks.head_logits``: a float32-accumulated
  channel contraction of the compute-dtype trunk plus a float32 bias.

The function is ``model(x)`` up to reassociation and the affine's dtype (the
kernel applies the float32 affine to its float32 accumulator, the module
path rounds the conv first and applies a compute-dtype affine). A batch of
N blocks is one launch per ConvBlock (the kernel's grid has the batch).

The conv kernels are re-laid and the affines folded once, when the apply is
built: build it after the checkpoint is loaded and the model is on its
device. No gradient path.
"""

from __future__ import annotations

import torch

from tpuseg_torch.core import ModelConfig
from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.models.blocks import ConvBlock, Up, head_logits
from tpuseg_torch.models.unet3d import UNet3D
from tpuseg_torch.ops.convblock import (block_bodies, fold_bn_affine,
                                        fused_convblock,
                                        fused_convblock_plain, kernel_weights)
from tpuseg_torch.ops.upconv import (kernel_takes, pack_upconv_weights,
                                     upsample_conv_cat,
                                     upsample_conv_cat_plain)


def fused_apply_supported(config: ModelConfig) -> bool:
    """The fused block is specialized to the flagship family: 32-channel
    full-resolution blocks, eval BatchNorm, ReLU; in bf16 each Up level's
    widths are ones the up-conv kernel takes (``ops.upconv.kernel_takes``:
    ci a multiple of 64 up to 320, co of 32)."""
    f = config.features
    return (
        config.norm == "batch"
        and config.activation == "relu"
        and len(f) >= 2
        and f[0] == 32
        and config.head_features == 32
        and (resolve(config.compute_dtype) != torch.bfloat16
             or all(kernel_takes(f[i + 1], f[i]) for i in range(len(f) - 1)))
    )


def _block_args(block: ConvBlock, compute_dtype: str):
    """ConvBlock -> ``fused_convblock``'s (w1, s1, b1, w2, s2, b2), each
    conv kernel re-laid for the body that runs it."""
    bodies = block_bodies(resolve(compute_dtype), block.conv0.weight.shape[1])
    out = []
    for conv, norm, body in ((block.conv0, block.norm0, bodies[0]),
                             (block.conv1, block.norm1, bodies[1])):
        s, b = fold_bn_affine(norm.weight.detach(), norm.bias.detach(),
                              norm.running_mean, norm.running_var, norm.eps)
        out += [kernel_weights(conv.weight, compute_dtype, body), s, b]
    return out


def _up_args(up: Up):
    """An Up level's k=2 conv -> ``upsample_conv_cat``'s (w, b): the kernel
    packed in bf16, the bias in bf16."""
    return (pack_upconv_weights(up.up_conv.weight.to(torch.bfloat16)),
            up.up_conv.bias.detach().to(torch.bfloat16))


def make_fused_apply(model: UNet3D, plain: bool = False):
    """Build ``apply_fn(x) -> {"fg_logits", "peak_logits"}`` for a U-Net in
    eval mode; raises ValueError for a config the fused block does not cover
    (:func:`fused_apply_supported`). ``plain=True`` runs the plain twins
    of the block and of the up-convs on whatever device ``x`` is on: the
    card's check of the kernels."""
    cfg = model.config
    if not fused_apply_supported(cfg):
        raise ValueError(
            "fused eval apply requires norm='batch', activation='relu', "
            "features[0]==head_features==32 and, in bfloat16, each Up "
            "level's ci a multiple of 64 up to 320 and co of 32; got "
            f"{cfg}")
    dtype = model.dtype
    levels = len(cfg.features)
    block_fn = fused_convblock_plain if plain else fused_convblock
    enc0, up0, trunk = (_block_args(b, cfg.compute_dtype) for b in
                        (model.enc0, model.up0.block, model.head_trunk))
    ups = [getattr(model, f"up{i}") for i in range(levels - 1)]
    if dtype == torch.bfloat16:
        up_args = [_up_args(up) for up in ups]
        up_fn = upsample_conv_cat_plain if plain else upsample_conv_cat

    def up_cat(i, h, skip):
        """Level i's up-conv of ``h`` concatenated with ``skip``."""
        if dtype == torch.bfloat16:
            return up_fn(h, skip, *up_args[i])
        return torch.cat([ups[i].up(h), skip.to(h.dtype)], dim=1)

    @torch.no_grad()
    def apply_fn(x):  # (N, 1, d, h, w) or (N, d, h, w)
        if model.training:
            raise RuntimeError("fused eval apply needs model.eval(): it "
                               "folds the running statistics")
        if x.dim() == 4:
            x = x[:, None]
        skip0 = block_fn(x.to(dtype), *enc0, cfg.compute_dtype)
        h = skip0
        skips = []
        for i in range(1, levels - 1):
            h = getattr(model, f"enc{i}")(getattr(model, f"down{i - 1}")(h))
            skips.append(h)
        h = model.bottleneck(getattr(model, f"down{levels - 2}")(h))
        for i in reversed(range(1, levels - 1)):
            h = ups[i].block(up_cat(i, h, skips[i - 1]))
        t = block_fn(up_cat(0, h, skip0), *up0, cfg.compute_dtype)
        t = block_fn(t, *trunk, cfg.compute_dtype)
        return {"fg_logits": head_logits(model.fg_head, t),
                "peak_logits": head_logits(model.peak_head, t)}

    return apply_fn
