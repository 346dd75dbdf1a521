"""The plain SwinUNETR: forward (and, under autograd, backward) from a state
dict, in float32, with the attention materialised.

The published net (Hatamizadeh et al., arXiv:2201.01266; MONAI's
``monai/networks/nets/swin_unetr.py``, SwinUNETR with ``normalize=True``,
``qkv_bias=True``, no dropout), written from its equations:

* patch embedding: Conv3d(in -> f, k 2, stride 2, bias); channels last;
* stage i (C = f 2^i): per block ``z = x + WA(LN1(x))``, ``x = z +
  fc2(GELU(fc1(LN2(z))))`` (fc1 to 4C, erf GELU); WA: LN1's output
  zero-padded at the high end to whole windows, rolled by -shift on every
  axis in odd blocks, cut into windows (``window_partition``'s order),
  ``softmax(q k^T * 16^-0.5 + B[rel] + M) v`` per window and head with the
  scores and the softmax as tensors, proj, the windows put back, rolled by
  +shift and cropped; B the (13^3, heads) table at
  ``((dz + 6) * 13 + dy + 6) * 13 + dx + 6``; M -100 between tokens of
  different shift regions (MONAI's ``compute_mask``: 3 slices an axis of
  the padded grid, counted over the 27 combinations) where a shift is on;
  a side of at most 7 tokens takes that side as its window and no shift
  (MONAI's ``get_window_size``); then patch merging: the 8 parity slices,
  LN(8C), a bias-free linear to 2C;
* hidden outputs: the non-affine LayerNorm of the embedding and of each
  stage's merged output;
* ``ResBlock(ci, co)``: ``lrelu(IN(conv2(lrelu(IN(conv1(x))))) + r)``, r =
  ``IN(conv3(x))`` (1x1x1) where ci != co else x; 3x3x3 convs, no bias,
  InstanceNorm without affine (eps 1e-5), LeakyReLU 0.01; ``Up(ci, co)``:
  ``ResBlock(2co, co)(cat[ConvTranspose3d(ci -> co, k 2, s 2, no
  bias)(x), skip])``; the encoders on the input and hidden outputs 0-2,
  the bottleneck on hidden output 4, Ups with skips hidden output 3, then
  the encoders' outputs, and a 1x1x1 conv (bias) whose channels 0 and 1
  are ``fg_logits`` and ``peak_logits``.

Departures from MONAI:

* a shrunk window's relative-position index is its own tokens'
  coordinates (MONAI slices the first n x n of the 7^3 window's index,
  which pairs tokens by their order in a 7^3 window);
* patch merging takes the slices in ``itertools.product`` order (MONAI's
  ``mergingv2``; its default ``merging`` keeps an older order for its
  checkpoints, and no checkpoint is loaded here);
* two output channels, the pipeline's fg and peak maps; parameter names
  are the port's (``arch/swin_unetr.state_shapes``), not MONAI's.

``quant``, where given, rounds every conv's, transposed conv's and
linear's input and kernel, and attention's q, k and v
(``reference/quant.py``: the controls' lower precisions). The net has no
running statistics: ``train`` and ``stats`` change nothing.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

EPS = 1e-5
SLOPE = 0.01
MASK = -100.0


def _q(quant, *ts):
    return ts if quant is None else tuple(quant(t) for t in ts)


def _linear(x, p, name, quant):
    x, w = _q(quant, x, p[f"{name}.weight"])
    return F.linear(x, w, p.get(f"{name}.bias"))


def _ln(x, p=None, name=None):
    w = b = None
    if name is not None:
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return F.layer_norm(x, x.shape[-1:], w, b, EPS)


def _window(grid, window, shifted):
    win = [g if g <= window else window for g in grid]
    shift = [0 if g <= window or not shifted else window // 2 for g in grid]
    return win, shift


def _partition(x, win):
    b, d, h, w, c = x.shape
    x = x.view(b, d // win[0], win[0], h // win[1], win[1], w // win[2],
               win[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, win[0] * win[1]
                                                      * win[2], c)


def _reverse(windows, win, b, d, h, w):
    x = windows.view(b, d // win[0], h // win[1], w // win[2], win[0],
                     win[1], win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def _rel_index(win, device):
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(k, device=device) for k in win], indexing="ij")
    ).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + 6
    return (rel[..., 0] * 13 + rel[..., 1]) * 13 + rel[..., 2]


def _mask(dims, win, shift, device):
    img = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    for d in (slice(-win[0]), slice(-win[0], -shift[0]),
              slice(-shift[0], None)):
        for h in (slice(-win[1]), slice(-win[1], -shift[1]),
                  slice(-shift[1], None)):
            for w in (slice(-win[2]), slice(-win[2], -shift[2]),
                      slice(-shift[2], None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    ids = _partition(img, win).squeeze(-1)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, MASK, 0.0)


def _swin_block(x, p, name, heads, shifted, quant):
    b, d, h, w, c = x.shape
    win, shift = _window((d, h, w), 7, shifted)
    pads = [(k - s % k) % k for s, k in zip((d, h, w), win)]
    y = F.pad(_ln(x, p, f"{name}.norm1"),
              (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dp, hp, wp = d + pads[0], h + pads[1], w + pads[2]
    if any(shift):
        y = torch.roll(y, [-s for s in shift], (1, 2, 3))
    win_x = _partition(y, win)
    bw, n, _ = win_x.shape
    qkv = _linear(win_x, p, f"{name}.attn.qkv", quant)
    q, k, v = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = _q(quant, q, k, v)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    table = p[f"{name}.attn.bias_table"]
    bias = table[_rel_index(win, x.device).reshape(-1)].reshape(n, n, -1)
    attn = attn + bias.permute(2, 0, 1)[None]
    if any(shift):
        mask = _mask((dp, hp, wp), win, shift, x.device)
        nw = mask.shape[0]
        attn = (attn.view(bw // nw, nw, heads, n, n) + mask[None, :, None]
                ).view(bw, heads, n, n)
    o = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(bw, n, c)
    o = _linear(o, p, f"{name}.attn.proj", quant)
    y = _reverse(o, win, b, dp, hp, wp)
    if any(shift):
        y = torch.roll(y, shift, (1, 2, 3))
    x = x + y[:, :d, :h, :w]
    m = _linear(_ln(x, p, f"{name}.norm2"), p, f"{name}.mlp.fc1", quant)
    return x + _linear(F.gelu(m), p, f"{name}.mlp.fc2", quant)


def _merge(x, p, name, quant):
    x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                   itertools.product(range(2), repeat=3)], -1)
    return _linear(_ln(x, p, f"{name}.norm"), p, f"{name}.reduction", quant)


def _conv(x, p, name, quant, **kw):
    x, w = _q(quant, x, p[f"{name}.weight"])
    return F.conv3d(x, w, p.get(f"{name}.bias"), **kw)


def _in(x):
    var, mean = torch.var_mean(x, (2, 3, 4), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS)


def _res_block(x, p, name, quant):
    y = F.leaky_relu(_in(_conv(x, p, f"{name}.conv1", quant, padding=1)),
                     SLOPE)
    y = _in(_conv(y, p, f"{name}.conv2", quant, padding=1))
    if f"{name}.conv3.weight" in p:
        x = _in(_conv(x, p, f"{name}.conv3", quant))
    return F.leaky_relu(y + x, SLOPE)


def _up(x, skip, p, name, quant):
    x, w = _q(quant, x, p[f"{name}.up"])
    y = F.conv_transpose3d(x, w, stride=2)
    return _res_block(torch.cat([y, skip], 1), p, f"{name}.block", quant)


def _hidden(x):
    return _ln(x).permute(0, 4, 1, 2, 3)


def forward(p: dict, x: torch.Tensor, model: dict, train: bool = False,
            stats: dict | None = None, quant=None) -> dict:
    """``{"fg_logits", "peak_logits"}`` (N, D, H, W) float32 of the
    (N, D, H, W) or (N, 1, D, H, W) float32 ``x`` (sides multiples of
    32); ``p`` maps the parameter names to float32 tensors, ``model`` is a
    configuration's ``model`` group (``num_heads``, ``depths``)."""
    if x.dim() == 4:
        x = x[:, None]
    assert model["window_size"] == 7 and model["patch_size"] == 2
    assert all(s % 32 == 0 for s in x.shape[2:]), x.shape
    t = _conv(x, p, "patch_embed", quant, stride=2).permute(0, 2, 3, 4, 1)
    hidden = [_hidden(t)]
    for i, (depth, heads) in enumerate(zip(model["depths"],
                                           model["num_heads"])):
        for j in range(depth):
            t = _swin_block(t, p, f"layers.{i}.blocks.{j}", heads, j % 2 == 1,
                            quant)
        t = _merge(t, p, f"layers.{i}.merge", quant)
        hidden.append(_hidden(t))
    e0 = _res_block(x, p, "enc0", quant)
    e1 = _res_block(hidden[0], p, "enc1", quant)
    e2 = _res_block(hidden[1], p, "enc2", quant)
    e3 = _res_block(hidden[2], p, "enc3", quant)
    y = _up(_res_block(hidden[4], p, "bottleneck", quant), hidden[3], p,
            "dec4", quant)
    for name, skip in (("dec3", e3), ("dec2", e2), ("dec1", e1),
                       ("dec0", e0)):
        y = _up(y, skip, p, name, quant)
    out = _conv(y, p, "head", quant)
    return {"fg_logits": out[:, 0], "peak_logits": out[:, 1]}
