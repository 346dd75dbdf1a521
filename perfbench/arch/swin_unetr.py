"""SwinUNETR (arXiv:2201.01266; MONAI's ``swin_unetr.py``) behind the
harness's architecture seam (``cells.load_arch``).

The program's model is ``tpuseg_torch.models.SwinUNETR`` built from the
configuration's ``model`` group as a ``SwinUNETRConfig``; nothing of it goes
into the program's ``ModelConfig``, which is the U-Net's. Its state, in the
program's parameter names: linears and relative-position tables normal with
std 0.02, conv and transposed-conv kernels LeCun normal, all drawn on the
device from a seed in one call; biases 0; LayerNorm affines (1, 0). It has
no statistics. The plain float32 reference is ``reference/swin_unetr.py``.
The work: the forward's FLOPs per block voxel, and the shifted-window
attention kernel's (W1) FLOPs and bytes over a stack's blocks.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import swin_unetr
from perfbench.work import tile_blocks

#: what the trained weights' cache key hashes for this architecture
SOURCES = ("arch/swin_unetr.py", "reference/swin_unetr.py")
#: the published ROI, a side of the blocks :func:`flops_per_voxel` counts
ROI = 96
HEAD_DIM = 16
BF16_BYTES = 2


def program_overrides(model: dict) -> dict:
    """None: the ``model`` group builds the program's own config."""
    return {}


def build(cfg, model: dict, device) -> torch.nn.Module:
    """The program's module; the window, the patch and the parameters'
    dtype are the program's constants, which the configuration states and
    this checks."""
    from tpuseg_torch.models import SwinUNETR, SwinUNETRConfig
    from tpuseg_torch.models.swin_unetr import PATCH, WINDOW

    fixed = {"window_size": WINDOW, "patch_size": PATCH,
             "param_dtype": "float32"}
    for k, v in fixed.items():
        if model[k] != v:
            raise ValueError(f"SwinUNETR here takes {k} {v}; the "
                             f"configuration states {model[k]}")
    return SwinUNETR(SwinUNETRConfig(
        **{k: v for k, v in model.items() if k not in fixed})).to(device)


def _res_block(name: str, ci: int, co: int) -> dict:
    out = {f"{name}.conv1.weight": (co, ci, 3, 3, 3),
           f"{name}.conv2.weight": (co, co, 3, 3, 3)}
    if ci != co:
        out[f"{name}.conv3.weight"] = (co, ci, 1, 1, 1)
    return out


def state_shapes(model: dict) -> dict:
    """Parameter name -> shape, the program's names and order."""
    f, ci = model["feature_size"], model["in_channels"]
    side = 2 * model["window_size"] - 1
    out = {"patch_embed.weight": (f, ci, 2, 2, 2), "patch_embed.bias": (f,)}
    for i, (depth, heads) in enumerate(zip(model["depths"],
                                           model["num_heads"])):
        c, hid = f * 2 ** i, int(f * 2 ** i * model["mlp_ratio"])
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            out.update({f"{b}.norm1.weight": (c,), f"{b}.norm1.bias": (c,),
                        f"{b}.attn.bias_table": (side ** 3, heads),
                        f"{b}.attn.qkv.weight": (3 * c, c),
                        f"{b}.attn.qkv.bias": (3 * c,),
                        f"{b}.attn.proj.weight": (c, c),
                        f"{b}.attn.proj.bias": (c,),
                        f"{b}.norm2.weight": (c,), f"{b}.norm2.bias": (c,),
                        f"{b}.mlp.fc1.weight": (hid, c),
                        f"{b}.mlp.fc1.bias": (hid,),
                        f"{b}.mlp.fc2.weight": (c, hid),
                        f"{b}.mlp.fc2.bias": (c,)})
        m = f"layers.{i}.merge"
        out.update({f"{m}.norm.weight": (8 * c,), f"{m}.norm.bias": (8 * c,),
                    f"{m}.reduction.weight": (2 * c, 8 * c)})
    out.update(_res_block("enc0", ci, f))
    out.update(_res_block("enc1", f, f))
    out.update(_res_block("enc2", 2 * f, 2 * f))
    out.update(_res_block("enc3", 4 * f, 4 * f))
    out.update(_res_block("bottleneck", 16 * f, 16 * f))
    for name, a, b in (("dec4", 16, 8), ("dec3", 8, 4), ("dec2", 4, 2),
                       ("dec1", 2, 1), ("dec0", 1, 1)):
        out[f"{name}.up"] = (a * f, b * f, 2, 2, 2)
        out.update(_res_block(f"{name}.block", 2 * b * f, b * f))
    out.update({"head.weight": (model["out_channels"], f, 1, 1, 1),
                "head.bias": (model["out_channels"],)})
    return out


def _drawn(name: str, shape) -> float | None:
    """The scale a drawn leaf takes (None: not drawn)."""
    if name.endswith(".bias") or len(shape) == 1:
        return None
    if len(shape) == 2:                       # linears, tables
        return 0.02
    fan_in = shape[0] if name.endswith(".up") else math.prod(shape[1:])
    return 1.0 / math.sqrt(fan_in)


def init_state(model: dict, seed: int, device) -> dict:
    shapes = state_shapes(model)
    drawn = [k for k, s in shapes.items() if _drawn(k, s) is not None]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(math.prod(shapes[k]) for k in drawn),
                       generator=g, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        scale = _drawn(k, shape)
        if scale is not None:
            n = math.prod(shape)
            out[k] = flat[at:at + n].view(shape) * scale
            at += n
        elif k.endswith(".weight"):           # LayerNorm affines
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def is_statistic(name: str) -> bool:
    """None: InstanceNorm and LayerNorm keep no running statistics."""
    return False


def forward(p: dict, x: torch.Tensor, model: dict, train: bool = False,
            stats: dict | None = None, quant=None) -> dict:
    return swin_unetr.forward(p, x, model, train=train, stats=stats,
                              quant=quant)


def _windows(grid, window: int) -> tuple:
    """``(window, padded grid)`` of a stage's token grid."""
    win = [min(window, g) for g in grid]
    return win, [-(-g // w) * w for g, w in zip(grid, win)]


def _stages(model: dict, block) -> list:
    """Per stage: ``(C, heads, depth, tokens, padded tokens, window
    tokens)`` of a block of shape ``block``."""
    out = []
    for i, (depth, heads) in enumerate(zip(model["depths"],
                                           model["num_heads"])):
        grid = [s // 2 ** (i + 1) for s in block]
        win, padded = _windows(grid, model["window_size"])
        out.append((model["feature_size"] * 2 ** i, heads, depth,
                    math.prod(grid), math.prod(padded), math.prod(win)))
    return out


def flops_per_voxel(model: dict) -> float:
    """Forward FLOPs per voxel of a ROI^3 block (a multiply-add is two),
    attention and linears over the unpadded tokens: the patch embedding,
    per Swin block the qkv, proj and MLP linears (24 C^2 a token) and
    attention (4 N C a token, N the window's tokens), the mergings (32 C^2
    an output token), every ResBlock's convs, the transposed convs (2 ci co
    an output voxel) and the head. Counted by torch's ``FlopCounterMode``
    on the program's model, the padded tokens' linears and attention
    included, the same terms sum to 718,893 a voxel at feature 48."""
    f, ci, co = (model["feature_size"], model["in_channels"],
                 model["out_channels"])
    mlp = model["mlp_ratio"]
    vox = ROI ** 3
    total = 2 * 8 * ci * f * vox / 8
    for c, heads, depth, tokens, _, n in _stages(model, (ROI,) * 3):
        linears = 2 * c * 3 * c + 2 * c * c + 2 * 2 * c * mlp * c
        total += depth * tokens * (linears + 4 * n * c)
        total += tokens / 8 * 2 * 8 * c * 2 * c

    def res(a, b):
        return 2 * 27 * a * b + 2 * 27 * b * b + (2 * a * b if a != b else 0)

    for a, b, level in ((ci, f, 0), (f, f, 1), (2 * f, 2 * f, 2),
                        (4 * f, 4 * f, 3), (16 * f, 16 * f, 5)):
        total += res(a, b) * vox / 8 ** level
    for a, b, level in ((16 * f, 8 * f, 4), (8 * f, 4 * f, 3),
                        (4 * f, 2 * f, 2), (2 * f, f, 1), (f, f, 0)):
        total += (2 * a * b + res(2 * b, b)) * vox / 8 ** level
    total += 2 * f * co * vox
    return total / vox


def wattn_work(model: dict, block) -> tuple:
    """``(FLOPs, bytes)`` of the attention kernel over one block: per
    (window, head) 4 N^2 16 FLOPs over the padded grid's windows (the
    kernel's work); each padded token's q, k, v read and its output written
    once in bf16."""
    flops = nbytes = 0
    for c, heads, depth, _, padded, n in _stages(model, block):
        flops += depth * (padded // n) * heads * 4 * n * n * HEAD_DIM
        nbytes += depth * padded * 4 * c * BF16_BYTES
    return flops, nbytes


def work(model: dict, kind: str, **shapes) -> dict:
    """W1's work over one stack (``shape``, ``tile``, ``halo``): every swept
    block's (``work.tile_blocks``), and each Swin block's float32 table
    read once (a launch reads it once; blocks share launches)."""
    if kind != "infer":
        return {}
    n, _ = tile_blocks(shapes["shape"], shapes["tile"], shapes["halo"])
    halo = shapes["halo"]
    halo = tuple(halo) if isinstance(halo, (list, tuple)) else (halo,) * 3
    block = [t + 2 * h for t, h in zip(shapes["tile"], halo)]
    flops, nbytes = wattn_work(model, block)
    tables = sum(depth * (2 * model["window_size"] - 1) ** 3 * heads * 4
                 for depth, heads in zip(model["depths"], model["num_heads"]))
    return {"wattn": (n * flops, n * nbytes + tables)}
