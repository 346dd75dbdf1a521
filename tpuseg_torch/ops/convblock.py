"""The fused full-resolution eval ConvBlock (K4; port of
``tpuseg/ops/pallas_convblock.py``).

``fused_convblock(x, w1, s1, b1, w2, s2, b2, compute_dtype)`` computes

    out = relu(aff2(conv2(T))),   T = relu(aff1(conv1(x)))

for 3x3x3 SAME convolutions with 32 output channels on NCDHW ``x``
(N, ci, D, H, W), where ``aff(v) = v * s + b`` per channel is an eval
BatchNorm folded by :func:`fold_bn_affine`. ``x`` and the conv kernels are
rounded to the compute dtype (bf16 or f32), products are accumulated in
float32, the affine and the ReLU run in float32, and there is one rounding
to the compute dtype at T and one at the output — the rounding points of
the TPU kernel and of its ``reference_convblock``. Inference only.

* A CUDA tensor launches a hand-written kernel of ``csrc/convblock.cu``,
  which keeps T in shared memory (any N, ci, D, H, W: edges are masked in
  the kernel), or raises; a CPU tensor takes :func:`fused_convblock_plain`.
  Which body computes each conv is a fixed function of (compute dtype, ci),
  :func:`block_bodies`. bfloat16 launches the tensor-core kernel: conv2
  (32 -> 32) always runs as a bf16 implicit GEMM with ``wgmma`` (``"mma"``),
  conv1 too for ci = 32 or 64, and on the CUDA cores (``"fma"``) inside the
  same kernel for other ci (enc0's ci = 1). float32, whose contract is
  exact float32 products, launches the CUDA-core kernel for both convs.
  ``.launches`` counts kernel launches, ``.mma_launches`` those of the
  tensor-core kernel.
* ``w1`` / ``w2`` are conv kernels in the torch layout (32, ci, 3, 3, 3), or
  the same already re-laid: by :func:`pack_weights` as the (ci, 27, 32)
  float32 tile, or by :func:`kernel_weights` as the form the conv's body
  takes (what ``models/fused_eval.make_fused_apply`` does once per model).
* ``fused_convblock_plain`` — the twin: two float32 ``F.conv3d`` calls on
  the rounded operands with the same epilogues, on any device. On the card
  its float32 case needs ``torch.backends.cudnn.allow_tf32 = False``.

The TPU version's lane layout (``to_chw``, ``WPAD``, ``pad_flat``), its
channel padding (``CI_ALIGN``), ``pack_weights_33``, ``h_splits`` and the
ablation knobs serve Mosaic's tiling and VMEM and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.core.dtypes import resolve
from tpuseg_torch.ops import _build
from tpuseg_torch.ops.conv_mma import pack_mma_weights, unpack_mma_weights

CO = 32          # output channels of every full-res conv in the flagship net
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def fold_bn_affine(weight, bias, running_mean, running_var,
                   eps: float = 1e-5):
    """Eval BatchNorm -> per-channel float32 ``(scale, bias)`` with
    ``scale = weight * rsqrt(var + eps)``, ``bias = bias - mean * scale``."""
    s = torch.rsqrt(running_var.float() + eps) * weight.float()
    return s, bias.float() - running_mean.float() * s


def pack_weights(w: torch.Tensor, compute_dtype="bfloat16") -> torch.Tensor:
    """(co, ci, 3, 3, 3) conv kernel -> the kernel's weight tile (ci, 27, co)
    in float32, tap = (kd*3 + kh)*3 + kw, holding the values rounded to the
    compute dtype."""
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"pack_weights takes (co, ci, 3, 3, 3); got "
                         f"{tuple(w.shape)}")
    co, ci = w.shape[:2]
    w = w.detach().to(resolve(compute_dtype)).float()
    return w.permute(1, 2, 3, 4, 0).reshape(ci, 27, co).contiguous()


def block_bodies(dtype: torch.dtype, ci: int) -> tuple[str, str]:
    """The bodies :func:`fused_convblock` runs (conv1, conv2) on in ``dtype``
    with ``ci`` input channels: ``"mma"`` (tensor cores) or ``"fma"`` (CUDA
    cores)."""
    if dtype != torch.bfloat16:
        return "fma", "fma"
    return ("mma" if ci in (32, 64) else "fma"), "mma"


def _packed(w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Any accepted weight form -> the (ci, 27, co) float32 tile."""
    if w.dim() == 4:
        return unpack_mma_weights(w)
    return w if w.dim() == 3 else pack_weights(w, compute_dtype)


def kernel_weights(w: torch.Tensor, compute_dtype, body: str) -> torch.Tensor:
    """A conv kernel in any accepted form -> the form ``body`` takes: the
    (27, ci / 8, co, 8) bfloat16 tile of ``ops.conv_mma`` for ``"mma"``, the
    (ci, 27, co) float32 tile for ``"fma"``."""
    if body == "mma":
        return (w if w.dim() == 4
                else pack_mma_weights(_packed(w, compute_dtype)))
    return _packed(w, compute_dtype)


def _unpacked(wk: torch.Tensor) -> torch.Tensor:
    """(ci, 27, co) -> (co, ci, 3, 3, 3)."""
    ci, _, co = wk.shape
    return wk.reshape(ci, 3, 3, 3, co).permute(4, 0, 1, 2, 3)


def fused_convblock_plain(x, w1, s1, b1, w2, s2, b2,
                          compute_dtype="bfloat16") -> torch.Tensor:
    """Twin of :func:`fused_convblock` in plain PyTorch, on any device."""
    dtype = resolve(compute_dtype)

    def one(x, w, s, b):
        w = (w.to(dtype).float() if w.dim() == 5
             else _unpacked(_packed(w, compute_dtype)))
        y = F.conv3d(x.float(), w, padding=1)
        y = y * s.float().view(1, -1, 1, 1, 1) + b.float().view(1, -1, 1, 1, 1)
        return torch.relu(y).to(dtype)

    return one(one(x.to(dtype), w1, s1, b1), w2, s2, b2)


def fused_convblock(x, w1, s1, b1, w2, s2, b2,
                    compute_dtype="bfloat16") -> torch.Tensor:
    """x (N, ci, D, H, W) -> (N, 32, D, H, W) in the compute dtype; s*, b*
    are (32,) float32 affines. No autograd."""
    if x.device.type == "cpu":
        return fused_convblock_plain(x, w1, s1, b1, w2, s2, b2, compute_dtype)
    dtype = resolve(compute_dtype)
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_convblock kernel computes in float32 or "
                         f"bfloat16; got {compute_dtype}")
    if x.dim() != 5:
        raise ValueError(f"fused_convblock needs x (N, ci, D, H, W); got "
                         f"{tuple(x.shape)}")
    bodies = block_bodies(dtype, x.shape[1])
    w1k = kernel_weights(w1, compute_dtype, bodies[0])
    w2k = kernel_weights(w2, compute_dtype, bodies[1])
    want = [(27, c // 8, CO, 8) if b == "mma" else (c, 27, CO)
            for b, c in zip(bodies, (x.shape[1], CO))]
    if [tuple(w1k.shape), tuple(w2k.shape)] != want:
        raise ValueError(f"fused_convblock needs x (N, ci, D, H, W), w1 "
                         f"({CO}, ci, 3, 3, 3) and w2 ({CO}, {CO}, 3, 3, 3); got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    n, ci, d, h, wd = x.shape
    if -(-h // 8) > 65535 or n * -(-d // 16) > 65535:
        raise ValueError(f"fused_convblock kernel grid limit: N={n}, D={d}, "
                         f"H={h}")
    x = x.to(dtype).contiguous()
    args = [w1k, s1, b1, w2k, s2, b2]
    # the tensor-core body takes its weights in bf16, all else is float32
    dtypes = [torch.float32] * 6
    dtypes[0], dtypes[3] = (torch.bfloat16 if b == "mma" else torch.float32
                            for b in bodies)
    for i, t in enumerate(args):
        if t.device != x.device:
            raise ValueError(f"fused_convblock: weights on {t.device}, x on "
                             f"{x.device}")
        args[i] = t.detach().to(dtypes[i]).contiguous()
    if any(t.shape != (CO,) for t in args[1:3] + args[4:6]):
        raise ValueError(f"fused_convblock: affines must be ({CO},)")
    y = torch.empty((n, CO, d, h, wd), dtype=dtype, device=x.device)
    ptrs = [t.data_ptr() for t in args]
    if bodies[1] == "mma":
        err = _build.load().tpuseg_convblock_mma(
            x.data_ptr(), *ptrs, y.data_ptr(), n, ci, d, h, wd,
            int(bodies[0] == "mma"), _build.stream_ptr())
        _build.check(err, "fused_convblock (mma)")
        fused_convblock.mma_launches += 1
    else:
        err = _build.load().tpuseg_convblock(
            x.data_ptr(), *ptrs, y.data_ptr(), n, ci, d, h, wd,
            _build.stream_ptr())
        _build.check(err, "fused_convblock")
    fused_convblock.launches += 1
    return y


fused_convblock.launches = 0
fused_convblock.mma_launches = 0
