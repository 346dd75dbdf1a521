"""SwinUNETR's ResBlock convolutions (R1, ``csrc/rconv.cu``; no Pallas
counterpart: the net is the port's own).

``rconv(x, w)`` computes the bias-free 3x3x3 SAME convolution of NCDHW
``x`` (N, ci, D, H, W) with the module weight ``w`` (co, ci, 3, 3, 3): the
operands in x's dtype (the weight rounded to it), the sums in float32, each
output rounded to x's dtype once, which is what cuDNN computes for the
module. ``channel_product(x, w, b)`` computes a 1x1x1 conv (ResBlock's
conv3, the head) as one matrix product over channels on the NCDHW view.

* A CUDA tensor launches the kernel, bf16 only: for ci a multiple of 16
  and co of 48 the tensor-core body (``wgmma``; output voxels as the
  GEMM's M side), for ci = 1 and co a multiple of 4 up to 48 the CUDA-core
  body; the launch follows from the
  shape alone (:func:`rconv_plan`). It reads and writes NCDHW, contiguous,
  takes the module's float32 weights, and raises on any other dtype, shape
  or layout. A kernel packs the weights per call into the layout of
  :func:`pack_rconv_weights`, inside a captured graph too; the wrapper
  allocates only its output, the packed weights and, where the depth
  splits, the float32 partial sums, and reads nothing from the host. No
  atomics: the same input gives the same bits on every call.
  ``.launches`` counts the conv kernel's launches, one a call.
* A CPU tensor takes :func:`rconv_plain`, the twin: ``F.conv3d`` in
  float32 on the same operands, rounded once.
* It refuses a ci that is neither 1 nor a multiple of 16, on every device,
  and autograd (there is no backward).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpuseg_torch.ops import _build

KC = 16                   # input channels of a depth chunk
#: the output box of a unit of the box body, (planes, rows, columns), by
#: its N tile
BOXES = {48: (4, 8, 16), 96: (4, 8, 8)}
CI1_MAX_CO = 48           # the ci = 1 body: four channels a warp, 12 warps
MIN_CHUNKS = 4            # depth chunks a split piece keeps at least


class Plan(NamedTuple):
    body: str             # "mma" or "ci1"
    nc: int               # output channels of a unit of work
    split: int            # pieces the depth is split over
    ctas: int             # persistent CTAs of the mma body (0 for ci1)


def check_channels(ci: int) -> None:
    if ci != 1 and ci % KC:
        raise ValueError(f"rconv takes ci = 1 or a multiple of {KC}; got "
                         f"ci = {ci}")


def _split(units: int, chunks: int, sms: int) -> int:
    """Depth pieces: halve the depth while the units would still fill at
    most one wave of the card and each piece keeps ``MIN_CHUNKS`` chunks."""
    split = 1
    while (2 * split * units <= sms and chunks % (2 * split) == 0
           and chunks // (2 * split) >= MIN_CHUNKS):
        split *= 2
    return split


def rconv_plan(n: int, ci: int, co: int, d: int, h: int, w: int,
               sms: int) -> Plan:
    """The launch of a (n, ci, d, h, w) -> co call on a card of ``sms``
    SMs. ci = 1 takes the CUDA-core body. Else the box body: units of one
    box of ``BOXES[nc]`` voxels and nc output channels, nc 96 where co is a
    multiple of 96, else 48, its depth split by :func:`_split` (four ways
    at 6^3 and 3^3 in the net). One persistent CTA an SM, at most one a
    unit."""
    check_channels(ci)
    if ci == 1:
        if co % 4 or not 4 <= co <= CI1_MAX_CO:
            raise ValueError(f"rconv at ci = 1 takes co a multiple of 4 up "
                             f"to {CI1_MAX_CO}; got {co}")
        return Plan("ci1", co, 1, 0)
    if co % 48:
        raise ValueError(f"rconv takes co a multiple of 48; got {co}")
    nc = 96 if co % 96 == 0 else 48
    bz, by, bx = BOXES[nc]
    units = n * (co // nc) * -(-d // bz) * -(-h // by) * -(-w // bx)
    split = _split(units, ci // KC, sms)
    return Plan("mma", nc, split, min(sms, units * split))


def pack_rconv_weights(w: torch.Tensor, nc: int) -> torch.Tensor:
    """(co, ci, 3, 3, 3) -> (co / nc, ci / 16, 27, 2, nc, 8) bf16,
    contiguous: ``out[j, c, t, g, o, k] = bf16(w[nc j + o, 16 c + 8 g + k,
    t])``, t = kd * 9 + kh * 3 + kw: per (channel chunk, depth chunk) one
    contiguous block, per tap a K-major wgmma B operand (``ops.conv_mma``'s
    layout at 16 input channels)."""
    co, ci = w.shape[:2]
    if tuple(w.shape[2:]) != (3, 3, 3) or co % nc or ci % KC:
        raise ValueError(f"pack_rconv_weights takes (co, ci, 3, 3, 3) with "
                         f"co a multiple of {nc}, ci of {KC}; got "
                         f"{tuple(w.shape)}")
    return (w.detach().to(torch.bfloat16)
            .view(co // nc, nc, ci // KC, 2, 8, 27)
            .permute(0, 2, 5, 3, 1, 4).contiguous())


def unpack_rconv_weights(wp: torch.Tensor) -> torch.Tensor:
    """The packed weights -> (co, ci, 3, 3, 3) in their dtype."""
    j, c, taps, g, nc, k = wp.shape
    if (taps, g, k) != (27, 2, 8):
        raise ValueError(f"unpack_rconv_weights takes (co / nc, ci / 16, 27, "
                         f"2, nc, 8); got {tuple(wp.shape)}")
    return (wp.permute(0, 4, 1, 3, 5, 2)
            .reshape(j * nc, c * KC, 3, 3, 3))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) \
            or w.shape[1] != x.shape[1]:
        raise ValueError(f"rconv takes x (N, ci, D, H, W) and w (co, ci, 3, "
                         f"3, 3); got {tuple(x.shape)}, {tuple(w.shape)}")
    check_channels(x.shape[1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("rconv is inference only: it has no backward "
                           "(run under torch.no_grad())")


def rconv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`rconv` on any device: ``F.conv3d`` in float32 (TF32
    off) of x and w rounded to x's dtype, rounded to it once."""
    _check(x, w)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv3d(x.float(), w.detach().to(x.dtype).float(), padding=1)
    return y.to(x.dtype)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, ci, D, H, W) * (co, ci, 3, 3, 3) -> (N, co, D, H, W) in x's
    dtype (module docstring)."""
    _check(x, w)
    if x.device.type == "cpu":
        return rconv_plain(x, w)
    n, ci, d, h, wd = x.shape
    co = w.shape[0]
    if (x.dtype != torch.bfloat16 or w.dtype != torch.float32
            or not (x.is_contiguous() and w.is_contiguous())
            or w.device != x.device or w.data_ptr() % 16):
        raise ValueError(f"rconv kernel takes contiguous bf16 x and the "
                         f"module's float32 w, 16-byte aligned, on its "
                         f"device; got {x.dtype}, {w.dtype} on {w.device}, "
                         f"contiguous {x.is_contiguous()}, "
                         f"{w.is_contiguous()}")
    plan = rconv_plan(n, ci, co, d, h, wd, _sm_count(x.device))
    if max(-(-d // 4), n) > 65535:
        raise ValueError(f"rconv kernel: {tuple(x.shape)} exceeds its grid")
    y = torch.empty((n, co, d, h, wd), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib, stream = _build.load(), _build.stream_ptr()
    if plan.body == "ci1":
        _build.check(lib.tpuseg_rconv_ci1(x.data_ptr(), w.data_ptr(),
                                          y.data_ptr(), n, co, d, h, wd,
                                          stream), "rconv (ci = 1)")
    else:
        wp = torch.empty((co // plan.nc, ci // KC, 27, 2, plan.nc, 8),
                         dtype=torch.bfloat16, device=x.device)
        _build.check(lib.tpuseg_rconv_pack(w.data_ptr(), wp.data_ptr(), ci,
                                           co, plan.nc, stream),
                     "rconv weight packing")
        part = (torch.empty((plan.split, n, co, d, h, wd),
                            dtype=torch.float32, device=x.device)
                if plan.split > 1 else None)
        _build.check(lib.tpuseg_rconv(
            x.data_ptr(), wp.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), n, ci, co, d, h, wd,
            plan.nc, plan.split, plan.ctas, stream), "rconv")
    rconv.launches += 1
    return y


rconv.launches = 0


def channel_product(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """A 1x1x1 conv on NCDHW ``x``: ``w`` (co, ci, 1, 1, 1) times each
    voxel's channels, ``torch.matmul`` of (co, ci) by (N, ci, D*H*W), in
    x's dtype; then ``b`` added in x's dtype, as ``models.blocks.Conv3d``
    adds it."""
    n, ci = x.shape[:2]
    co = w.shape[0]
    y = torch.matmul(w.to(x.dtype).reshape(co, ci),
                     x.reshape(n, ci, -1)).view(n, co, *x.shape[2:])
    if b is not None:
        y = y + b.to(x.dtype).view(1, -1, 1, 1, 1)
    return y
