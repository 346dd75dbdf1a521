"""InstanceNorm, residual add and LeakyReLU of SwinUNETR's ResBlocks in two
passes (N1, ``csrc/instnorm.cu``; no Pallas counterpart).

``instance_norm_lrelu(a, r=None, norm_r=False, weight=None, bias=None,
slope=0.01)`` computes, for tensors (N, C, *spatial) whose (n, c) planes
lie contiguous,

    lrelu(IN(a) * g + b + R),   R = 0 (``r`` None), ``r`` as it lies, or
                                IN(r) (``norm_r``)

with ``IN(t) = (t - mean) * (var + 1e-5)^-1/2`` over each (n, c) plane
(biased variance; a plane of one voxel normalizes to 0), ``g`` and ``b``
the per-channel ``weight`` and ``bias`` (float32; left out where not
given) and ``lrelu(y) = y if y > 0 else slope * y``: a SwinUNETR
ResBlock's two normalizations, after conv1 (R = 0) and after conv2 (R =
the block's input, or conv3's output normalized where the channels
change), and MedNeXt's GroupNorm of one group a channel (``weight``,
``bias``, R = 0, slope 1: the identity).

* A CUDA tensor launches the kernel pair: a statistics pass (float32
  count, mean and M2 of each chunk of ``CHUNK`` voxels of a plane, exact
  over each 16-byte vector and merged by Chan's rule in a fixed order; r's
  too under ``norm_r``, in the same launch) and an apply pass (each CTA
  merges its plane's partials in a fixed order, then reads ``a`` and ``r``
  once and writes the result once). The whole expression is computed in
  float32 and rounded to the storage dtype once. It takes bf16 or float32
  storage, ``a`` and ``r`` of one shape and dtype, contiguous and 16-byte
  aligned, planes of at most 2^24 voxels, or raises. No atomics: the same
  input gives the same bits on every call. ``.launches`` counts the
  kernels' launches, two a call.
* A CPU tensor takes :func:`instance_norm_lrelu_plain`, the twin:
  ``torch.instance_norm``, the add and ``F.leaky_relu`` in the storage
  dtype, each rounding on its own (bf16 rounds three times where the kernel
  rounds once); with ``weight``, ``F.group_norm`` of one group a channel
  in float32 of the stored values, the add and the activation, rounded
  once.
* Inference only: under autograd (grad enabled and an input that requires
  it) the wrapper raises on every device; there is no backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpuseg_torch.ops import _build

EPS = 1e-5
SLOPE = 0.01
#: voxels of a plane a CTA covers (a multiple of every 16-byte vector)
CHUNK = 16384
#: the largest plane whose float32 counts stay exact
MAX_PLANE = 2 ** 24


def _instance_norm(t: torch.Tensor) -> torch.Tensor:
    """Non-affine InstanceNorm, eps ``EPS``: the op itself, since
    ``F.instance_norm`` refuses a plane of one voxel (a 32^3 block's
    bottleneck), which normalizes to 0."""
    return torch.instance_norm(t, None, None, None, None, True, 0.0, EPS,
                               torch.backends.cudnn.enabled)


def instance_norm_lrelu_plain(a: torch.Tensor, r: torch.Tensor | None = None,
                              norm_r: bool = False,
                              weight: torch.Tensor | None = None,
                              bias: torch.Tensor | None = None,
                              slope: float = SLOPE) -> torch.Tensor:
    """Twin of :func:`instance_norm_lrelu` (module docstring), on any
    device and dtype."""
    if weight is None:
        y = _instance_norm(a)
        if r is not None:
            y = y + (_instance_norm(r) if norm_r else r)
        return F.leaky_relu(y, slope)
    y = F.group_norm(a.float(), a.shape[1], weight.detach().float(),
                     bias.detach().float(), EPS)
    if r is not None:
        y = y + (_instance_norm(r.float()) if norm_r else r.float())
    return F.leaky_relu(y, slope).to(a.dtype)


def _check(a, r, norm_r, weight=None, bias=None) -> None:
    if a.dim() < 3:
        raise ValueError(f"instance_norm_lrelu takes (N, C, *spatial); got "
                         f"{tuple(a.shape)}")
    if (weight is None) != (bias is None) or (weight is not None and (
            tuple(weight.shape) != (a.shape[1],) or weight.shape != bias.shape
            or weight.device != a.device)):
        raise ValueError(f"instance_norm_lrelu: weight and bias of "
                         f"({a.shape[1]},) on {a.device} together, or "
                         f"neither")
    if r is None:
        if norm_r:
            raise ValueError("instance_norm_lrelu: norm_r without r")
    elif (r.shape != a.shape or r.dtype != a.dtype
          or r.device != a.device):
        raise ValueError(f"instance_norm_lrelu: r {tuple(r.shape)} {r.dtype} "
                         f"on {r.device} against a {tuple(a.shape)} "
                         f"{a.dtype} on {a.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, r, weight, bias)):
        raise RuntimeError("instance_norm_lrelu is inference only: it has no "
                           "backward (run under torch.no_grad())")


def instance_norm_lrelu(a: torch.Tensor, r: torch.Tensor | None = None,
                        norm_r: bool = False,
                        weight: torch.Tensor | None = None,
                        bias: torch.Tensor | None = None,
                        slope: float = SLOPE) -> torch.Tensor:
    """``lrelu(IN(a) * g + b + R)`` in ``a``'s dtype (module docstring)."""
    _check(a, r, norm_r, weight, bias)
    if a.device.type == "cpu":
        return instance_norm_lrelu_plain(a, r, norm_r, weight, bias, slope)
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"instance_norm_lrelu kernel takes bf16 or float32; "
                         f"got {a.dtype}")
    tensors = (a,) if r is None else (a, r)
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("instance_norm_lrelu kernel needs contiguous, "
                         "16-byte aligned tensors")
    planes, plane = a.shape[0] * a.shape[1], math.prod(a.shape[2:])
    if plane > MAX_PLANE:
        raise ValueError(f"instance_norm_lrelu kernel takes planes of at most "
                         f"{MAX_PLANE} voxels; got {plane}")
    if weight is not None:
        weight = weight.detach().float().contiguous()
        bias = bias.detach().float().contiguous()
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    chunks = -(-plane // CHUNK)
    part = torch.empty((2 if norm_r else 1, planes, chunks, 4),
                       dtype=torch.float32, device=a.device)
    lib, stream = _build.load(), _build.stream_ptr()
    rp = None if r is None else r.data_ptr()
    _build.check(lib.tpuseg_instnorm_stats(
        a.data_ptr(), rp if norm_r else None, part.data_ptr(), planes, plane,
        CHUNK, a.element_size(), stream), "instance_norm_lrelu statistics")
    _build.check(lib.tpuseg_instnorm_apply(
        a.data_ptr(), rp, part.data_ptr(), out.data_ptr(), planes, plane,
        CHUNK, 0 if r is None else 2 if norm_r else 1, a.element_size(), EPS,
        slope, None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), a.shape[1], stream),
        "instance_norm_lrelu apply")
    instance_norm_lrelu.launches += 2
    return out


instance_norm_lrelu.launches = 0
