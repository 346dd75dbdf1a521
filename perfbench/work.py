"""The work the benchmark counts, from shapes alone, and the card's peaks.

* :func:`unet_convs`: every convolution of the 3D U-Net (the structure of
  ``tpuseg_torch/models/unet3d.py``: ConvBlock = two 3x3x3 convs, Down = a
  k=2 stride-2 conv, Up = nearest x2 + a k=2 conv + a ConvBlock on the
  concatenated skip, a head trunk ConvBlock and two 1x1x1 heads) with the
  resolution level it runs at;
* :func:`unet_flops_per_voxel`: the forward pass's FLOPs per input voxel,
  2 x k^3 x cin x cout per output voxel of each conv at 1/8^level of the
  input's voxels (norms and activations are bytes, not FLOPs);
* :func:`k4_work`, :func:`k6_work`: the FLOPs and the bytes of the layers
  the two convolution kernels compute, each input byte read once and each
  output byte written once.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

import math

BF16_FLOPS = 989e12         # tensor cores, bf16 dense
HBM_BYTES_PER_S = 3.35e12   # device memory
BF16_BYTES = 2


def unet_convs(features=(32, 64, 128, 256), in_channels: int = 1,
               head_features: int = 32) -> list:
    """``(module name, k, cin, cout, level)`` of every conv, in the model's
    module names."""
    f = features
    levels = len(f)
    out = []

    def block(name, cin, cout, level):
        out.append((f"{name}.conv0", 3, cin, cout, level))
        out.append((f"{name}.conv1", 3, cout, cout, level))

    for i in range(levels - 1):
        block(f"enc{i}", in_channels if i == 0 else f[i], f[i], i)
        out.append((f"down{i}.down", 2, f[i], f[i + 1], i + 1))
    block("bottleneck", f[-1] if levels > 1 else in_channels, f[-1],
          levels - 1)
    for i in reversed(range(levels - 1)):
        out.append((f"up{i}.up_conv", 2, f[i + 1], f[i], i))
        block(f"up{i}.block", 2 * f[i], f[i], i)
    block("head_trunk", f[0], head_features, 0)
    out.append(("fg_head", 1, head_features, 1, 0))
    out.append(("peak_head", 1, head_features, 1, 0))
    return out


def conv_flops(k: int, cin: int, cout: int) -> int:
    """FLOPs of one output voxel of a k^3 conv (a multiply-add is two)."""
    return 2 * k ** 3 * cin * cout


def unet_flops_per_voxel(features=(32, 64, 128, 256), in_channels: int = 1,
                         head_features: int = 32) -> float:
    """Forward FLOPs of the U-Net per input voxel."""
    return sum(conv_flops(k, ci, co) / 8 ** lvl for _, k, ci, co, lvl
               in unet_convs(features, in_channels, head_features))


#: the three full-resolution ConvBlocks K4 computes (``models/fused_eval``)
K4_BLOCKS = ("enc0", "up0.block", "head_trunk")
#: the six full-resolution 3x3x3 convs K6 computes (``models/fused_train``)
K6_BLOCKS = K4_BLOCKS


def _full_res_convs(model: dict, blocks) -> list:
    convs = unet_convs(model["features"], model["in_channels"],
                       model["head_features"])
    return [(ci, co) for name, k, ci, co, lvl in convs
            if k == 3 and lvl == 0 and name.rsplit(".", 1)[0] in blocks]


def tile_blocks(shape, tile, halo) -> tuple:
    """``(number of swept blocks, voxels of one block)`` of
    ``tpuseg_torch/infer/tiles.tiled_forward``: the volume padded up to the
    tile grid, each core tile widened by the halo on both sides."""
    halo = tuple(halo) if isinstance(halo, (list, tuple)) else (halo,) * 3
    n = math.prod(-(-s // t) for s, t in zip(shape, tile))
    return n, math.prod(t + 2 * h for t, h in zip(tile, halo))


def k4_work(model: dict, shape, tile, halo) -> tuple:
    """``(FLOPs, bytes)`` of the three full-resolution ConvBlocks over every
    swept block of one stack: per block voxel the six convs' FLOPs; each
    block's input (its channels) read and its 32-channel output written
    once in bf16 (the intermediate stays on chip), and each conv's bf16
    weights read once a block."""
    n, vox = tile_blocks(shape, tile, halo)
    convs = _full_res_convs(model, K4_BLOCKS)
    flops = n * vox * sum(conv_flops(3, ci, co) for ci, co in convs)
    ios = sum(ci + co for ci, co in convs[0::2])
    weights = sum(27 * ci * co for ci, co in convs)
    return flops, n * (vox * ios + weights) * BF16_BYTES


def k6_work(model: dict, batch: int, patch) -> tuple:
    """``(FLOPs, bytes)`` of the 3x3x3 convs K6 runs in one train step: the
    six full-resolution forwards and the five input gradients (not enc0's
    first, whose input is the image), each reading its bf16 input and
    weights and writing its bf16 output once."""
    vox = batch * math.prod(patch)
    fwd = _full_res_convs(model, K6_BLOCKS)
    dx = [(co, ci) for ci, co in fwd[1:]]
    flops = vox * sum(conv_flops(3, ci, co) for ci, co in fwd + dx)
    nbytes = sum(vox * (ci + co) + 27 * ci * co for ci, co in fwd + dx)
    return flops, nbytes * BF16_BYTES


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of FLOPs over the
    bf16 peak and bytes over the memory rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
