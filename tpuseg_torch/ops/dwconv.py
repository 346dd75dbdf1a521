"""MedNeXt's depthwise convolutions (D1, ``csrc/dwconv.cu``; no Pallas
counterpart: the net is the port's own).

``dwconv(x, w, b, stride=1, transposed=False)`` computes, for NCDHW ``x``
(N, C, D, H, W) and the module's depthwise kernel ``w`` (C, 1, 5, 5, 5)
and bias ``b`` (C,), each channel convolved with its own 5^3 kernel, pad
2, in one of three forms:

* ``stride=1``: ``F.conv3d(x, w, b, padding=2, groups=C)``, sides kept;
* ``stride=2``: the same at stride 2, sides ``(S - 1) // 2 + 1``;
* ``stride=2, transposed=True``: ``F.conv_transpose3d(x, w, b, stride=2,
  padding=2, groups=C)``, sides ``2S - 1``.

The operands in x's dtype (the weight and the bias rounded to it), the sums
in float32 with the bias, each output rounded to x's dtype once.

* A CUDA tensor launches the kernel, bf16 only: one CTA for a tile of one
  (n, c) plane, the tile's input box (zero outside the volume: the padding
  and the ragged sides are masked) staged in shared memory as float32, the
  plane's 125 taps rounded to bf16 in registers, float32 FMAs on the CUDA
  cores (a 5^3 tap does 125 FMAs an output, past the ridge of the card's
  float32 rate against its memory rate, and a tensor-core form would be
  bound by bytes instead). It takes the module's float32 weight and bias
  as they are, reads and writes NCDHW, contiguous, and raises on any other
  dtype, shape or layout. No atomics: the same input gives the
  same bits on every call. ``.launches`` counts launches, one a call.
* A CPU tensor takes :func:`dwconv_plain`, the twin: ``F.conv3d`` /
  ``F.conv_transpose3d`` with ``groups=C`` in float32 of the same operands
  (TF32 off), rounded once.
* Inference only: under autograd (grad enabled and an input that requires
  it) the wrapper raises on every device; there is no backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.ops import _build

K = 5                      # taps an axis
PAD = K // 2
#: the kernel's form codes
FORMS = {(1, False): 0, (2, False): 1, (2, True): 2}


def out_side(s: int, stride: int, transposed: bool) -> int:
    """An output side of the form."""
    if transposed:
        return (s - 1) * stride - 2 * PAD + K
    return (s + 2 * PAD - K) // stride + 1


def _check(x, w, b, stride, transposed) -> None:
    if (stride, transposed) not in FORMS:
        raise ValueError(f"dwconv computes stride 1, stride 2 and stride 2 "
                         f"transposed; got stride {stride}, transposed "
                         f"{transposed}")
    if x.dim() != 5:
        raise ValueError(f"dwconv takes (N, C, D, H, W); got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if tuple(w.shape) != (c, 1, K, K, K) or tuple(b.shape) != (c,):
        raise ValueError(f"dwconv: weight {tuple(w.shape)} and bias "
                         f"{tuple(b.shape)} against {c} channels (want ({c}, "
                         f"1, {K}, {K}, {K}), ({c},))")
    if min(x.shape[2:]) < 1:
        raise ValueError(f"dwconv: empty sides {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise RuntimeError("dwconv is inference only: it has no backward "
                           "(run under torch.no_grad())")


def dwconv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int = 1, transposed: bool = False) -> torch.Tensor:
    """Twin of :func:`dwconv` on any device: the library's grouped conv in
    float32 (TF32 off) of x, w and b rounded to x's dtype, rounded to it
    once."""
    _check(x, w, b, stride, transposed)
    dt = x.dtype
    w32 = w.detach().to(dt).float()
    b32 = b.detach().to(dt).float()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if transposed:
            y = F.conv_transpose3d(x.float(), w32, b32, stride=stride,
                                   padding=PAD, groups=x.shape[1])
        else:
            y = F.conv3d(x.float(), w32, b32, stride=stride, padding=PAD,
                         groups=x.shape[1])
    return y.to(dt)


def dwconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, transposed: bool = False) -> torch.Tensor:
    """Depthwise 5^3 conv of NCDHW ``x`` in x's dtype (module
    docstring)."""
    _check(x, w, b, stride, transposed)
    if x.device.type == "cpu":
        return dwconv_plain(x, w, b, stride, transposed)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"dwconv kernel takes bf16; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dwconv kernel needs a contiguous NCDHW tensor")
    n, c, d, h, wd = x.shape
    if n * c > 65535 or x.numel() >= 2 ** 31:
        raise ValueError(f"dwconv kernel takes at most 65535 planes of "
                         f"fewer than 2^31 elements; got {tuple(x.shape)}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"dwconv kernel takes the module's float32 weight "
                         f"and bias; got {w.dtype}, {b.dtype}")
    w, b = w.detach().contiguous(), b.detach().contiguous()
    side = [out_side(s, stride, transposed) for s in (d, h, wd)]
    out = torch.empty((n, c, *side), dtype=x.dtype, device=x.device)
    lib = _build.load()
    _build.check(lib.tpuseg_dwconv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n * c, c,
        d, h, wd, FORMS[stride, transposed], _build.stream_ptr()), "dwconv")
    dwconv.launches += 1
    return out


dwconv.launches = 0
