"""The training path's full-resolution 3x3x3 convolution (K6; port of
``tpuseg/ops/pallas_convtrain.py``).

* ``conv3x3_raw(x, w)`` — the kernel wrapper: a bias-free 3x3x3 SAME conv
  of NCDHW ``x`` with torch-layout weights ``w`` (co, ci, 3, 3, 3), both in
  the compute dtype (bf16 or f32), f32 accumulation, one rounding to that
  dtype. A CUDA tensor launches a hand-written kernel of
  ``csrc/convtrain.cu`` (any N, D, H, W: edges are masked in the kernel) or
  raises; a CPU tensor takes :func:`conv3x3_raw_plain`. Which of the two
  kernel bodies runs is a fixed function of (dtype, ci, co),
  :func:`conv_body`: ``"mma"``, the bf16 implicit GEMM on the tensor cores
  (``wgmma``), for bfloat16 with ci 16, 32 or 64 and co 32 or 64 (not both
  64) — the forward and dx of every 32- and 64-channel conv of a train
  step; ``"fma"``, the CUDA cores' float32 FMA kernel, for float32 (whose
  contract is exact float32 products) and for the other channel counts
  (ci = 1). ``.launches`` counts kernel launches of both bodies,
  ``.mma_launches`` those of the tensor-core body.
* ``conv3x3(x, w, compute_dtype)`` — differentiable, the counterpart of the
  ``conv3x3_p2`` custom_vjp: the forward and dx run ``conv3x3_raw`` (dx on
  the cotangent, rounded to the compute dtype, with :func:`flip_w` weights),
  dw is the library's conv weight-gradient in the compute dtype, as
  ``_conv_bwd`` leaves dw to XLA (the TPU kernel never computes dw).
* ``conv3x3_plain`` — the twin of ``conv3x3``: ``F.conv3d`` under autograd.

The TPU version's sample-pair lane packing (``pack2_w``), its block shape
guard (``convtrain_supported``) and the CO=32 padding are TPU layout limits
and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.ops import _build
from tpuseg_torch.ops.conv_mma import mma_supported, pack_mma_weights

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def flip_w(w: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3, 3) -> the conv-transpose kernel (ci, co, 3, 3, 3):
    spatially flipped, in/out channels swapped (``pallas_convtrain.flip_w``
    in the torch layout)."""
    return w.flip(2, 3, 4).transpose(0, 1)


def conv3x3_raw_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`conv3x3_raw` in plain PyTorch, on any device."""
    return F.conv3d(x, w, padding=1)


def conv_body(dtype: torch.dtype, ci: int, co: int) -> str:
    """The kernel body :func:`conv3x3_raw` launches for a (ci -> co) conv in
    ``dtype``: ``"mma"`` (tensor cores) or ``"fma"`` (CUDA cores)."""
    return ("mma" if dtype == torch.bfloat16 and mma_supported(ci, co)
            else "fma")


def conv3x3_raw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free 3x3x3 SAME conv: x (N, ci, D, H, W), w (co, ci, 3, 3, 3) of
    x's dtype -> (N, co, D, H, W) of that dtype. No autograd."""
    if x.device.type == "cpu":
        return conv3x3_raw_plain(x, w)
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3 kernel takes float32/bfloat16 x and w of "
                         f"one dtype; got {x.dtype}, {w.dtype}")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) \
            or w.shape[1] != x.shape[1] or w.device != x.device:
        raise ValueError(f"conv3x3 kernel needs x (N, ci, D, H, W) and w "
                         f"(co, ci, 3, 3, 3) on one device; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, ci, d, h, wd = x.shape
    co = w.shape[0]
    if d > 65535 or n * -(-co // 32) > 65535:
        raise ValueError(f"conv3x3 kernel grid limit: D={d}, N={n}, co={co}")
    x = x.contiguous()
    # (co, ci, kd, kh, kw) -> (ci, 27, co): the kernels' weight tile
    wk = w.permute(1, 2, 3, 4, 0).reshape(ci, 27, co)
    y = torch.empty((n, co, d, h, wd), dtype=x.dtype, device=x.device)
    if conv_body(x.dtype, ci, co) == "mma":
        wp = pack_mma_weights(wk)
        err = _build.load().tpuseg_conv3x3_mma(
            x.data_ptr(), wp.data_ptr(), y.data_ptr(), n, ci, co, d, h, wd,
            _build.stream_ptr())
        _build.check(err, "conv3x3_raw (mma)")
        conv3x3_raw.mma_launches += 1
    else:
        wk = wk.float().contiguous()
        err = _build.load().tpuseg_conv3x3(
            x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, ci, co, d, h, wd,
            int(x.dtype == torch.bfloat16), _build.stream_ptr())
        _build.check(err, "conv3x3_raw")
    conv3x3_raw.launches += 1
    return y


conv3x3_raw.launches = 0
conv3x3_raw.mma_launches = 0


class _Conv3x3(torch.autograd.Function):
    """``conv3x3_p2``'s custom_vjp: kernel forward, kernel dx with flipped
    weights, library dw."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        xc = x.to(dtype)
        wc = w.to(dtype)
        ctx.save_for_backward(xc, wc)
        ctx.dtypes = (x.dtype, w.dtype)
        return conv3x3_raw(xc, wc)

    @staticmethod
    def backward(ctx, dy):
        xc, wc = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        dy = dy.to(wc.dtype).contiguous()      # _conv_bwd rounds dy first
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_raw(dy, flip_w(wc).contiguous()).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(xc, wc.shape, dy,
                                             padding=1).to(w_dtype)
        return dx, dw, None


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Differentiable bias-free 3x3x3 SAME conv in ``compute_dtype`` (x and
    w of any float dtype are cast to it, as ``conv3x3_p2`` casts w);
    returns (N, co, D, H, W) in that dtype."""
    return _Conv3x3.apply(x, w, resolve(compute_dtype))


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Twin of :func:`conv3x3`: ``F.conv3d`` in the compute dtype under
    autograd, on any device."""
    dtype = resolve(compute_dtype)
    return F.conv3d(x.to(dtype), w.to(dtype), padding=1)
