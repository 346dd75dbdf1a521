"""The decoder's upsample-and-conv with its skip concatenation in one pass
(``csrc/upconv.cu``; no Pallas counterpart).

``upsample_conv_cat(x, skip, w, b)`` computes, for NCDHW ``x`` (N, ci, d,
h, w) and ``skip`` (N, co, 2d, 2h, 2w),

    cat([conv_k2(pad01(up2(x))) + b, skip], dim=1)   -> (N, 2co, 2d, 2h, 2w)

which is ``models.blocks.Up.up(x)`` followed by ``Up.forward``'s
concatenation: a nearest x2 upsample, a (0, 1) pad on each axis, the k=2
conv ``w`` (co, ci, 2, 2, 2) and its bias ``b`` (co,). It reads only the
coarse tensor (the parity form of ``csrc/upconv.cu``: the fine voxel
``2m + p`` is the sum over the 8 taps ``k`` of ``w_k . x[m + (p & k)]``,
zero past the end), with the module path's products and rounding points:
each tap's own weight in the compute dtype, products summed in float32 and
rounded once, then the bias added in the compute dtype.

* A CUDA tensor launches the kernel, which takes bf16 contiguous NCDHW
  tensors and channel counts that :func:`kernel_takes` (ci a multiple of
  64 up to 320, co of 32), or raises; a CPU tensor takes
  :func:`upsample_conv_cat_plain`. ``.launches`` counts the kernel's
  launches.
* ``w`` is the conv kernel packed by :func:`pack_upconv_weights` (what
  ``models/fused_eval.make_fused_apply`` does once per model), in bf16 for
  the kernel; ``b`` in any float dtype, rounded to bf16.
* :func:`upsample_conv_cat_plain` — the twin: the parity form in plain
  PyTorch on the coarse tensor, float32 sums, the same epilogue, on any
  device and in the input's dtype.
"""

from __future__ import annotations

import functools
import itertools

import torch
import torch.nn.functional as F

from tpuseg_torch.ops import _build

CO_CHUNK = 32       # output channels of a CTA
CI_CHUNK = 64       # input channels the kernel stages at a time
CI_MAX = 320        # weights and two windows within a CTA's shared memory
TILE = 64           # coarse voxels of a tile, along w
_PARITIES = tuple(itertools.product((0, 1), repeat=3))


def kernel_takes(ci: int, co: int) -> bool:
    """Whether the kernel computes an up-conv of ci input and co output
    channels: ci in whole staged pieces within its shared memory, co in
    whole CTA chunks."""
    return ci % CI_CHUNK == 0 and ci <= CI_MAX and co % CO_CHUNK == 0


def pack_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """(co, ci, 2, 2, 2) k=2 conv kernel -> (co / 32, 8, ci / 8, 32, 8) in
    w's dtype, contiguous: ``out[j, t, g, o, k] = w[32j + o, 8g + k, tap
    t]`` with ``t = kd * 4 + kh * 2 + kw``: per chunk of 32 output channels
    and tap, a K-major wgmma B operand (``ops.conv_mma``) once in bf16."""
    co, ci = w.shape[:2]
    if tuple(w.shape[2:]) != (2, 2, 2) or co % CO_CHUNK or ci % 8:
        raise ValueError(f"pack_upconv_weights takes (co, ci, 2, 2, 2) with "
                         f"co a multiple of {CO_CHUNK}, ci of 8; got "
                         f"{tuple(w.shape)}")
    return (w.detach().reshape(co // CO_CHUNK, CO_CHUNK, ci // 8, 8, 8)
            .permute(0, 4, 2, 1, 3).contiguous())


def _packed_co_ci(w: torch.Tensor) -> tuple[int, int]:
    """(co, ci) of a packed kernel; raises for any other shape."""
    if w.dim() != 5 or tuple(w.shape[i] for i in (1, 3, 4)) != (8, CO_CHUNK,
                                                               8):
        raise ValueError(f"upsample_conv_cat takes the kernel packed by "
                         f"pack_upconv_weights, (co / {CO_CHUNK}, 8, ci / 8, "
                         f"{CO_CHUNK}, 8); got {tuple(w.shape)}")
    return w.shape[0] * CO_CHUNK, w.shape[2] * 8


def unpack_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """The packed kernel -> the torch layout (co, ci, 2, 2, 2)."""
    co, ci = _packed_co_ci(w)
    return w.permute(0, 3, 2, 4, 1).reshape(co, ci, 2, 2, 2)


def upsample_conv_cat_plain(x, skip, w, b) -> torch.Tensor:
    """Twin of :func:`upsample_conv_cat` in plain PyTorch, on any device:
    per parity class one float32 product over the 8 taps x ci, taps
    outer and channels inner, the depth order of the kernel's GEMM."""
    dtype = x.dtype
    n, ci, d, h, wd = x.shape
    k = unpack_upconv_weights(w).to(dtype).float()
    co = k.shape[0]
    k = k.permute(0, 2, 3, 4, 1).reshape(co, 8 * ci)     # tap-major depth
    xp = F.pad(x.float(), (0, 1, 0, 1, 0, 1))
    acc = x.new_empty((n, co, d, 2, h, 2, wd, 2), dtype=torch.float32)
    for pd, ph, pw in _PARITIES:
        a = torch.cat([xp[:, :, sd:sd + d, sh:sh + h, sw:sw + wd]
                       for sd, sh, sw in ((pd & kd, ph & kh, pw & kw)
                                          for kd, kh, kw in _PARITIES)], 1)
        acc[:, :, :, pd, :, ph, :, pw] = torch.einsum("nkdhw,ok->nodhw", a, k)
    y = acc.reshape(n, co, 2 * d, 2 * h, 2 * wd).to(dtype)
    y = (y.float() + b.to(dtype).float().view(1, -1, 1, 1, 1)).to(dtype)
    return torch.cat([y, skip.to(dtype)], dim=1)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rows_per_cta(tiles: int, sms: int) -> int:
    """Rows of tiles a CTA walks along h: as many as leave 8 CTAs an SM,
    at most 8 (the weights are staged once a CTA)."""
    return max(1, min(8, tiles // (8 * sms)))


def upsample_conv_cat(x, skip, w, b) -> torch.Tensor:
    """x (N, ci, d, h, w), skip (N, co, 2d, 2h, 2w) -> (N, 2co, 2d, 2h, 2w)
    in x's dtype. No autograd."""
    if x.dim() != 5:
        raise ValueError(f"upsample_conv_cat needs x (N, ci, d, h, w); got "
                         f"{tuple(x.shape)}")
    n, ci, d, h, wd = x.shape
    co, wci = _packed_co_ci(w)
    if wci != ci or tuple(skip.shape) != (n, co, 2 * d, 2 * h, 2 * wd):
        raise ValueError(f"upsample_conv_cat: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and skip {tuple(skip.shape)} do "
                         "not fit: skip must be "
                         f"{(n, co, 2 * d, 2 * h, 2 * wd)}")
    if x.device.type == "cpu":
        return upsample_conv_cat_plain(x, skip, w, b)
    if x.dtype != torch.bfloat16 or skip.dtype != torch.bfloat16:
        raise ValueError(f"upsample_conv_cat kernel computes in bfloat16; "
                         f"got x {x.dtype}, skip {skip.dtype}")
    if not x.is_contiguous() or not skip.is_contiguous():
        raise ValueError("upsample_conv_cat kernel needs contiguous NCDHW x "
                         "and skip")
    if not kernel_takes(ci, co):
        raise ValueError(f"upsample_conv_cat kernel needs ci a multiple of "
                         f"{CI_CHUNK} up to {CI_MAX} and co of {CO_CHUNK}; "
                         f"got ci {ci}, co {co}")
    if w.dtype != torch.bfloat16 or not w.is_contiguous():
        raise ValueError(f"upsample_conv_cat kernel needs the packed kernel "
                         f"in contiguous bfloat16; got {w.dtype}")
    if n * d > 65535 or skip.data_ptr() % 4:
        raise ValueError(f"upsample_conv_cat kernel: grid limit N*d={n * d} "
                         "or skip not 4-byte aligned")
    b = b.detach().to(torch.bfloat16).contiguous()
    if b.shape != (co,) or w.device != x.device or b.device != x.device \
            or skip.device != x.device:
        raise ValueError(f"upsample_conv_cat: bias ({co},) and every tensor "
                         f"on {x.device}; got bias {tuple(b.shape)} on "
                         f"{b.device}, w on {w.device}, skip on "
                         f"{skip.device}")
    y = torch.empty((n, 2 * co, 2 * d, 2 * h, 2 * wd), dtype=x.dtype,
                    device=x.device)
    tiles = n * d * h * -(-wd // TILE) * (co // CO_CHUNK)
    rows = rows_per_cta(tiles, _sm_count(x.device))
    err = _build.load().tpuseg_upsample_conv_cat(
        x.data_ptr(), skip.data_ptr(), w.data_ptr(), b.data_ptr(),
        y.data_ptr(), n, ci, co, d, h, wd, rows, _build.stream_ptr())
    _build.check(err, "upsample_conv_cat")
    upsample_conv_cat.launches += 1
    return y


upsample_conv_cat.launches = 0
