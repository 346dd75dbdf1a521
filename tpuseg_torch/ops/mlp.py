"""MedNeXt's block MLP as one kernel (E1, ``csrc/mlp.cu``; no Pallas
counterpart: the net is the port's own).

``fused_mlp(a, w2, b2, w3, b3, r=None)`` computes, for NCDHW ``a`` (N, ci,
D, H, W), the module's 1x1x1 convs ``w2`` (e, ci, 1, 1, 1) and ``w3`` (co,
e, 1, 1, 1) with their biases ``b2`` (e,) and ``b3`` (co,), and an optional
residual ``r`` (N, co, D, H, W):

    y = w3 . bf16(GELU(w2 . a + b2)) + b3 (+ r)

each product over the channels of one voxel, GELU the exact erf form
(``F.gelu``'s default). The weights are rounded to a's dtype (the
tensor-core operands), the biases stay float32, the sums are float32, the
expanded value is rounded to a's dtype once (it is the second product's
operand) and the output once.

* A CUDA tensor launches the kernel, bf16 only: a packing launch (the
  float32 weights rounded into the layout the kernel stages) and the MLP,
  whose e-wide expanded tensor never reaches device memory (module comment
  of ``csrc/mlp.cu``). It takes the shapes of MedNeXt-L's 62 calls
  (:data:`TILINGS`), reads and writes NCDHW, contiguous, and raises on any
  other dtype, shape or layout. No atomics: the same input gives the same
  bits on every call. ``.launches`` counts the MLP kernel's launches, one a
  call.
* A CPU tensor takes :func:`fused_mlp_plain`, the twin: float32 products
  of the same operands, the expanded value rounded to a's dtype, one
  final rounding (a float32 input is not rounded at all).
* Inference only: under autograd (grad enabled and an input that requires
  it) the wrapper raises on every device; there is no backward.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpuseg_torch.ops import _build

TILE = 64                  # voxels of a tile: the kernel's M side
MAX_NCO = 256              # output channels of a unit of work
#: the tilings the kernel is built for: (ci, output channels of a unit) ->
#: expanded channels of a chunk. MedNeXt-L's blocks: level 0 (32 -> 96 ->
#: 32), 1 (64, 256), 2 (128, 1024), 3 (256, 2048), 4 (512, 4096, 512 in two
#: slices); its down blocks (ci -> 2 ci) and up blocks (ci -> ci / 2)
TILINGS = {(32, 32): 96, (64, 32): 96, (32, 64): 64, (64, 64): 64,
           (128, 64): 64, (64, 128): 64, (128, 128): 64, (256, 128): 64,
           (128, 256): 64, (256, 256): 64, (512, 256): 32}


class Plan(NamedTuple):
    nco: int               # output channels of a unit
    ec: int                # expanded channels of a chunk
    slices: int            # units a tile: co / nco
    chunks: int            # e / ec
    resident: bool         # the weights are staged once a CTA


def mlp_plan(ci: int, e: int, co: int) -> Plan:
    """The kernel's tiling of a (ci -> e -> co) MLP: output channels in
    slices of at most 256, the expanded channels in chunks of
    :data:`TILINGS`; raises for a shape it is not built for."""
    nco = min(co, MAX_NCO)
    ec = TILINGS.get((ci, nco))
    if ec is None or co % nco or e % ec:
        raise ValueError(
            f"fused_mlp kernel takes MedNeXt-L's shapes (ci, co) in "
            f"{sorted(TILINGS)} (co above {MAX_NCO} in slices of {MAX_NCO}) "
            f"with e a multiple of the tiling's chunk; got ci {ci}, e {e}, "
            f"co {co}")
    chunks = e // ec
    return Plan(nco, ec, co // nco, chunks, chunks <= 2 and co == nco)


def _check(a, w2, b2, w3, b3, r) -> None:
    if a.dim() != 5:
        raise ValueError(f"fused_mlp takes (N, C, D, H, W); got "
                         f"{tuple(a.shape)}")
    n, ci = a.shape[:2]
    e, co = w2.shape[0], w3.shape[0]
    if (tuple(w2.shape) != (e, ci, 1, 1, 1)
            or tuple(w3.shape) != (co, e, 1, 1, 1)
            or tuple(b2.shape) != (e,) or tuple(b3.shape) != (co,)):
        raise ValueError(f"fused_mlp: weights {tuple(w2.shape)}, "
                         f"{tuple(w3.shape)} and biases {tuple(b2.shape)}, "
                         f"{tuple(b3.shape)} against {ci} input channels "
                         f"(want (e, {ci}, 1, 1, 1), (co, e, 1, 1, 1), (e,), "
                         f"(co,))")
    if r is not None and (tuple(r.shape) != (n, co, *a.shape[2:])
                          or r.dtype != a.dtype):
        raise ValueError(f"fused_mlp: residual {tuple(r.shape)} {r.dtype} "
                         f"against the output {(n, co, *a.shape[2:])} "
                         f"{a.dtype}")
    if min(a.shape[2:]) < 1:
        raise ValueError(f"fused_mlp: empty sides {tuple(a.shape)}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, w2, b2, w3, b3, r)):
        raise RuntimeError("fused_mlp is inference only: it has no backward "
                           "(run under torch.no_grad())")


def fused_mlp_plain(a: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    w3: torch.Tensor, b3: torch.Tensor,
                    r: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of :func:`fused_mlp` on any device: float32 matrix products of
    a and the weights rounded to a's dtype (TF32 off on the card, torch's
    default), the float32 biases, ``F.gelu`` in float32, the expanded value
    rounded to a's dtype, the residual added to the float32 sum, one final
    rounding."""
    _check(a, w2, b2, w3, b3, r)
    dt = a.dtype
    n, ci = a.shape[:2]
    e, co = w2.shape[0], w3.shape[0]
    w2f = w2.detach().to(dt).float().reshape(e, ci)
    w3f = w3.detach().to(dt).float().reshape(co, e)
    h = torch.matmul(w2f, a.float().reshape(n, ci, -1))
    h = F.gelu(h + b2.detach().float().view(1, -1, 1)).to(dt).float()
    y = torch.matmul(w3f, h) + b3.detach().float().view(1, -1, 1)
    if r is not None:
        y = y + r.float().reshape(n, co, -1)
    return y.to(dt).view(n, co, *a.shape[2:])


def fused_mlp(a: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              w3: torch.Tensor, b3: torch.Tensor,
              r: torch.Tensor | None = None) -> torch.Tensor:
    """The block MLP of NCDHW ``a`` in a's dtype (module docstring)."""
    _check(a, w2, b2, w3, b3, r)
    if a.device.type == "cpu":
        return fused_mlp_plain(a, w2, b2, w3, b3, r)
    if a.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp kernel takes bf16; got {a.dtype}")
    if not a.is_contiguous() or (r is not None and not r.is_contiguous()):
        raise ValueError("fused_mlp kernel needs contiguous NCDHW tensors")
    if any(t.dtype != torch.float32 for t in (w2, b2, w3, b3)):
        raise ValueError(f"fused_mlp kernel takes the module's float32 "
                         f"weights and biases; got {w2.dtype}, {b2.dtype}, "
                         f"{w3.dtype}, {b3.dtype}")
    n, ci = a.shape[:2]
    e, co = w2.shape[0], w3.shape[0]
    vox = math.prod(a.shape[2:])
    if max(a.numel(), n * co * vox) >= 2 ** 31:
        raise ValueError(f"fused_mlp kernel takes tensors of fewer than "
                         f"2^31 elements; got {tuple(a.shape)} -> {co}")
    plan = mlp_plan(ci, e, co)
    w2, b2, w3, b3 = (t.detach().contiguous() for t in (w2, b2, w3, b3))
    if w2.data_ptr() % 16 or w3.data_ptr() % 16:
        raise ValueError("fused_mlp kernel reads the weights in 16-byte "
                         "vectors: they must start 16-byte aligned")
    wp = torch.empty(e * ci + co * e, dtype=torch.bfloat16, device=a.device)
    out = torch.empty((n, co, *a.shape[2:]), dtype=a.dtype, device=a.device)
    lib = _build.load()
    _build.check(lib.tpuseg_fused_mlp(
        a.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
        b3.data_ptr(), None if r is None else r.data_ptr(), wp.data_ptr(),
        out.data_ptr(), n, ci, e, co, vox, plan.ec, plan.nco,
        _build.stream_ptr()), "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
