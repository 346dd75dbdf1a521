"""The plain 3D U-Net: forward (and, under autograd, backward) from a state
dict, in float32.

The published structure (Cicek et al., arXiv:1606.06650, as the nuclei net
of Dong et al., MICCAI 2019), with the widths and parameter names of the
configurations' files: per level a ConvBlock ((3x3x3 conv -> BatchNorm ->
ReLU) twice, the convs without bias), a k=2 stride-2 conv down; a
bottleneck ConvBlock; per level up a nearest x2 upsample, a (0, 1) zero pad
on each axis and a k=2 conv, the skip concatenated after it, a ConvBlock; a
head trunk ConvBlock and two 1x1x1 heads. BatchNorm in eval mode
normalizes by the running statistics; in train mode by the batch's mean
and biased variance, and updates the running statistics in place by
``0.9 * old + 0.1 * batch``.

``quant``, where given, rounds every conv's input and kernel before the
conv (``reference/quant.py``: the controls' lower precisions).
:func:`tiled_logits`, the inference configurations' tile sweep, takes the
forward it sweeps, of this or any other architecture.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.9


def _bn(x, p: dict, name: str, train: bool, stats: dict | None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        dims = (0, 2, 3, 4)
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        if stats is not None:
            with torch.no_grad():
                for key, v in ((f"{name}.running_mean", mean),
                               (f"{name}.running_var", var)):
                    stats[key].mul_(MOMENTUM).add_((1 - MOMENTUM) * v)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = (w * torch.rsqrt(var + EPS)).view(1, -1, 1, 1, 1)
    return (x - mean.view(1, -1, 1, 1, 1)) * scale + b.view(1, -1, 1, 1, 1)


def _conv(x, p: dict, name: str, quant, **kw):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    y = F.conv3d(x, w, **kw)
    bias = p.get(f"{name}.bias")
    return y if bias is None else y + bias.view(1, -1, 1, 1, 1)


def _block(x, p, name, train, stats, quant):
    for i in range(2):
        x = _conv(x, p, f"{name}.conv{i}", quant, padding=1)
        x = torch.relu(_bn(x, p, f"{name}.norm{i}", train, stats))
    return x


def forward(p: dict, x: torch.Tensor, levels: int = 4, train: bool = False,
            stats: dict | None = None, quant=None) -> dict:
    """``{"fg_logits", "peak_logits"}`` (N, D, H, W) float32 of the
    (N, D, H, W) or (N, 1, D, H, W) float32 ``x``. ``p`` maps parameter
    and buffer names to float32 tensors; ``stats`` (train mode): the
    running statistics to update in place."""
    if x.dim() == 4:
        x = x[:, None]
    skips = []
    for i in range(levels - 1):
        x = _block(x, p, f"enc{i}", train, stats, quant)
        skips.append(x)
        x = _conv(x, p, f"down{i}.down", quant, stride=2)
    x = _block(x, p, "bottleneck", train, stats, quant)
    for i in reversed(range(levels - 1)):
        x = x.repeat_interleave(2, 2).repeat_interleave(2, 3) \
            .repeat_interleave(2, 4)
        x = _conv(F.pad(x, (0, 1, 0, 1, 0, 1)), p, f"up{i}.up_conv", quant)
        x = _block(torch.cat([x, skips[i]], 1), p, f"up{i}.block", train,
                   stats, quant)
    t = _block(x, p, "head_trunk", train, stats, quant)
    return {"fg_logits": _conv(t, p, "fg_head", quant)[:, 0],
            "peak_logits": _conv(t, p, "peak_head", quant)[:, 0]}


def tiled_logits(forward, volume: torch.Tensor, tile, halo,
                 preprocess) -> dict:
    """Whole-volume logits over the tile grid of an inference
    configuration: the volume edge-padded up to whole tiles and by the halo
    on both sides, each core tile's block (core + halo) run through
    ``forward`` ((1, d, h, w) float32 -> ``{"fg_logits", "peak_logits"}``
    of that shape, any architecture's) after ``preprocess``, and its core
    kept. Float32, one block at a time."""
    dd, hh, ww = volume.shape
    td, th, tw = tile
    hd, hy, hx = halo
    pads = [-(-s // t) * t - s for s, t in zip(volume.shape, tile)]
    padded = F.pad(volume[None, None], (hx, hx + pads[2], hy, hy + pads[1],
                                        hd, hd + pads[0]),
                   mode="replicate")[0, 0]
    out = {k: torch.empty((dd + pads[0], hh + pads[1], ww + pads[2]),
                          dtype=torch.float32, device=volume.device)
           for k in ("fg_logits", "peak_logits")}
    with torch.no_grad():
        for z in range(0, dd + pads[0], td):
            for y in range(0, hh + pads[1], th):
                for x in range(0, ww + pads[2], tw):
                    block = padded[z:z + td + 2 * hd, y:y + th + 2 * hy,
                                   x:x + tw + 2 * hx]
                    res = forward(preprocess(block)[None])
                    for k in out:
                        out[k][z:z + td, y:y + th, x:x + tw] = \
                            res[k][0, hd:hd + td, hy:hy + th, hx:hx + tw]
                    del res
    return {k: v[:dd, :hh, :ww] for k, v in out.items()}
