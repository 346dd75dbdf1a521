"""Weight layout of the tensor-core convolution bodies (``csrc/conv_mma.cuh``,
shared by K6's and K4's bf16 kernels).

The kernels run a 3x3x3 conv as 27 shifted GEMMs with ``wgmma``; the B
operand of tap ``t`` is that tap's (ci x co) weight slice, read from shared
memory K-major in 8 x 8 core matrices: ``[27][ci / 8][co][8]`` bfloat16,
where the last axis is 8 consecutive input channels (one 16-byte word).
:func:`pack_mma_weights` makes that image from the (ci, 27, co) weight tile
the CUDA-core bodies take (``ops.convblock.pack_weights``), and
:func:`unpack_mma_weights` inverts it.
"""

from __future__ import annotations

import torch

#: channel counts the tensor-core bodies are built for (wgmma's depth step
#: is 16 channels), with the weights (27 * ci * co bf16) beside the
#: activation ring within one block's shared memory
MMA_CI = (16, 32, 64)
MMA_CO = (32, 64)
MMA_MAX_CI_CO = 2048


def mma_supported(ci: int, co: int) -> bool:
    """Whether the tensor-core bodies take a (ci -> co) 3x3x3 conv."""
    return ci in MMA_CI and co in MMA_CO and ci * co <= MMA_MAX_CI_CO


def pack_mma_weights(wk: torch.Tensor) -> torch.Tensor:
    """(ci, 27, co) weight tile -> (27, ci / 8, co, 8) bfloat16, contiguous:
    ``out[t, g, o, k] = bf16(wk[8 * g + k, t, o])``."""
    ci, taps, co = wk.shape
    if taps != 27 or ci % 8 != 0:
        raise ValueError(f"pack_mma_weights takes (ci, 27, co) with ci a "
                         f"multiple of 8; got {tuple(wk.shape)}")
    return (wk.detach().permute(1, 0, 2).reshape(27, ci // 8, 8, co)
            .permute(0, 1, 3, 2).to(torch.bfloat16).contiguous())


def unpack_mma_weights(wp: torch.Tensor) -> torch.Tensor:
    """(27, ci / 8, co, 8) -> the (ci, 27, co) float32 weight tile."""
    taps, groups, co, _ = wp.shape
    return (wp.float().permute(0, 1, 3, 2).reshape(taps, groups * 8, co)
            .permute(1, 0, 2).contiguous())
