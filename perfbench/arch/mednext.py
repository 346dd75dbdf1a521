"""MedNeXt (arXiv:2303.09975; MIC-DKFZ's ``mednextv1``) behind the
harness's architecture seam (``cells.load_arch``).

The program's model is ``tpuseg_torch.models.MedNeXt`` built from the
configuration's ``model`` group as a ``MedNeXtConfig``; nothing of it goes
into the program's ``ModelConfig``, which is the U-Net's. Its state, in the
program's parameter names: conv and transposed-conv kernels normal with
std 1 / sqrt(fan in), all drawn on the device from a seed in one call;
biases 0; GroupNorm affines (1, 0). It has no statistics. The plain
float32 reference is ``reference/mednext.py``. The work: the forward's
FLOPs per block voxel, and the depthwise-conv kernel's (D1) FLOPs and
bytes over a stack's blocks.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from perfbench.reference import mednext
from perfbench.work import tile_blocks

#: what the trained weights' cache key hashes for this architecture
SOURCES = ("arch/mednext.py", "reference/mednext.py")
#: the published patch, a side of the blocks :func:`flops_per_voxel` counts
ROI = 128
LEVELS = mednext.LEVELS
BF16_BYTES = 2
#: the program's module of the net: a checkout whose program lacks it
#: cannot run a MedNeXt cell, and is told so before the weights are trained
PROGRAM = Path(__file__).resolve().parents[2] / "tpuseg_torch" / "models" \
    / "mednext.py"


def program_overrides(model: dict) -> dict:
    """None: the ``model`` group builds the program's own config."""
    return {}


def build(cfg, model: dict, device) -> torch.nn.Module:
    """The program's module; the parameters' dtype is the program's
    constant, which the configuration states and this checks."""
    from tpuseg_torch.models import MedNeXt, MedNeXtConfig

    if model["param_dtype"] != "float32":
        raise ValueError(f"MedNeXt here takes param_dtype float32; the "
                         f"configuration states {model['param_dtype']}")
    return MedNeXt(MedNeXtConfig(
        **{k: v for k, v in model.items() if k != "param_dtype"})).to(device)


def _block(name: str, ci: int, co: int, r: int, k: int, kind: str) -> dict:
    out = {f"{name}.conv1.weight": (ci, 1, k, k, k),
           f"{name}.conv1.bias": (ci,),
           f"{name}.norm.weight": (ci,), f"{name}.norm.bias": (ci,),
           f"{name}.conv2.weight": (r * ci, ci, 1, 1, 1),
           f"{name}.conv2.bias": (r * ci,),
           f"{name}.conv3.weight": (co, r * ci, 1, 1, 1),
           f"{name}.conv3.bias": (co,)}
    if kind == "down":
        out.update({f"{name}.res_conv.weight": (co, ci, 1, 1, 1),
                    f"{name}.res_conv.bias": (co,)})
    elif kind == "up":                       # ConvTranspose3d: (in, out, ...)
        out.update({f"{name}.res_conv.weight": (ci, co, 1, 1, 1),
                    f"{name}.res_conv.bias": (co,)})
    return out


def state_shapes(model: dict) -> dict:
    """Parameter name -> shape, the program's names and order."""
    c, k = model["n_channels"], model["kernel_size"]
    r, n = model["exp_r"], model["block_counts"]
    out = {"stem.weight": (c, model["in_channels"], 1, 1, 1),
           "stem.bias": (c,)}
    for i in range(LEVELS):
        for j in range(n[i]):
            out.update(_block(f"enc.{i}.{j}", c * 2 ** i, c * 2 ** i, r[i], k,
                              "block"))
    for i in range(LEVELS):
        out.update(_block(f"down.{i}", c * 2 ** i, c * 2 ** (i + 1),
                          r[i + 1], k, "down"))
    for j in range(n[LEVELS]):
        out.update(_block(f"bottleneck.{j}", c * 2 ** LEVELS,
                          c * 2 ** LEVELS, r[LEVELS], k, "block"))
    for i in range(LEVELS):
        out.update(_block(f"up.{i}", c * 2 ** (i + 1), c * 2 ** i,
                          r[2 * LEVELS - i], k, "up"))
    for i in range(LEVELS):
        for j in range(n[2 * LEVELS - i]):
            out.update(_block(f"dec.{i}.{j}", c * 2 ** i, c * 2 ** i,
                              r[2 * LEVELS - i], k, "block"))
    out.update({"head.weight": (c, model["out_channels"], 1, 1, 1),
                "head.bias": (model["out_channels"],)})
    return out


def _fan_in(name: str, shape) -> int:
    """The inputs one output sums: a conv's input channels a group times
    its taps; a 1x1x1 transposed conv's (the up blocks' residual, the head)
    its input channels."""
    if name == "head.weight" or (name.startswith("up.")
                                 and ".res_conv." in name):
        return shape[0]
    return math.prod(shape[1:])


def init_state(model: dict, seed: int, device) -> dict:
    if not PROGRAM.is_file():
        raise RuntimeError(f"the program has no MedNeXt ({PROGRAM} is "
                           f"missing): it cannot run this configuration")
    shapes = state_shapes(model)
    drawn = [k for k, s in shapes.items() if len(s) > 1]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(math.prod(shapes[k]) for k in drawn),
                       generator=g, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if len(shape) > 1:
            n = math.prod(shape)
            out[k] = flat[at:at + n].view(shape) / math.sqrt(_fan_in(k, shape))
            at += n
        elif k.endswith(".norm.weight"):      # GroupNorm affines
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def is_statistic(name: str) -> bool:
    """None: GroupNorm keeps no running statistics."""
    return False


def forward(p: dict, x: torch.Tensor, model: dict, train: bool = False,
            stats: dict | None = None, quant=None) -> dict:
    return mednext.forward(p, x, model, train=train, stats=stats,
                           quant=quant)


def _sides(block, level: int) -> list:
    return [s // 2 ** level for s in block]


def dwconv_calls(model: dict, block) -> list:
    """``(channels, input voxels, output voxels, transposed)`` of every
    depthwise conv of one block of shape ``block``, in the forward's
    order."""
    c, n = model["n_channels"], model["block_counts"]
    vox = [math.prod(_sides(block, i)) for i in range(LEVELS + 1)]
    odd = [math.prod(2 * s - 1 for s in _sides(block, i + 1))
           for i in range(LEVELS)]
    calls = [(c, vox[0], vox[0], False)] * n[0]
    for i in range(1, LEVELS + 1):
        w = c * 2 ** (i - 1)
        calls.append((w, vox[i - 1], vox[i], False))          # down
        calls += [(2 * w, vox[i], vox[i], False)] * n[i]
    for i in reversed(range(LEVELS)):
        w = c * 2 ** (i + 1)
        calls.append((w, vox[i + 1], odd[i], True))           # up
        calls += [(w // 2, vox[i], vox[i], False)] * n[2 * LEVELS - i]
    return calls


def flops(model: dict, block) -> float:
    """Forward FLOPs of one block of shape ``block`` (a multiply-add is
    two), as torch's ``FlopCounterMode`` counts the program's convs and
    products: each depthwise conv 2 k^3 C an output voxel (the transposed
    form: an input voxel), each 1x1x1 conv 2 ci co an output voxel (the
    up blocks' expansion and compression over their (2S - 1)^3 voxels,
    their transposed residual over its input voxels), the stem and the
    head. GroupNorm, GELU and the adds are bytes, not FLOPs."""
    c, k3 = model["n_channels"], model["kernel_size"] ** 3
    r, n = model["exp_r"], model["block_counts"]
    ci, co = model["in_channels"], model["out_channels"]
    vox = [math.prod(_sides(block, i)) for i in range(LEVELS + 1)]
    total = 2.0 * ci * c * vox[0] + 2.0 * c * co * vox[0]
    for w, vin, vout, transposed in dwconv_calls(model, block):
        total += 2.0 * k3 * w * (vin if transposed else vout)

    def mlp(w, e, w_out, v):               # conv2 to e w, conv3 to w_out
        return (2.0 * w * e * w + 2.0 * e * w * w_out) * v

    for i in range(LEVELS + 1):                # blocks' expansions
        w = c * 2 ** i
        total += n[i] * mlp(w, r[i], w, vox[i])
        if i < LEVELS:
            total += n[2 * LEVELS - i] * mlp(w, r[2 * LEVELS - i], w, vox[i])
    for i in range(LEVELS):
        w = c * 2 ** i                         # down: level i -> i + 1
        total += mlp(w, r[i + 1], 2 * w, vox[i + 1]) \
            + 2.0 * w * 2 * w * vox[i + 1]
        w = c * 2 ** (i + 1)                   # up: level i + 1 -> i
        odd = math.prod(2 * s - 1 for s in _sides(block, i + 1))
        total += mlp(w, r[2 * LEVELS - i], w // 2, odd) \
            + 2.0 * w * (w // 2) * vox[i + 1]
    return total


def flops_per_voxel(model: dict) -> float:
    """Forward FLOPs per voxel of a ROI^3 block (:func:`flops`)."""
    return flops(model, (ROI,) * 3) / ROI ** 3


def dwconv_work(model: dict, block) -> tuple:
    """``(FLOPs, bytes)`` of D1 over one block: 2 k^3 FLOPs an output
    element (the transposed form: an input element), each input element
    read and each output element written once in bf16."""
    k3 = model["kernel_size"] ** 3
    f = b = 0
    for w, vin, vout, transposed in dwconv_calls(model, block):
        f += 2 * k3 * w * (vin if transposed else vout)
        b += w * (vin + vout) * BF16_BYTES
    return f, b


def work(model: dict, kind: str, **shapes) -> dict:
    """D1's work over one stack (``shape``, ``tile``, ``halo``): every
    swept block's (``work.tile_blocks``), and each depthwise kernel and
    bias read once in float32 (a launch reads its channels' once; blocks
    share launches)."""
    if kind != "infer":
        return {}
    n, _ = tile_blocks(shapes["shape"], shapes["tile"], shapes["halo"])
    halo = shapes["halo"]
    halo = tuple(halo) if isinstance(halo, (list, tuple)) else (halo,) * 3
    block = [t + 2 * h for t, h in zip(shapes["tile"], halo)]
    f, b = dwconv_work(model, block)
    k3 = model["kernel_size"] ** 3
    weights = sum(4 * (k3 + 1) * w for w, *_ in dwconv_calls(model, block))
    return {"dwconv": (n * f, n * b + weights)}
