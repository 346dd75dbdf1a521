"""Shifted-window attention of SwinUNETR's Swin blocks in one pass (W1,
``csrc/window_attn.cu``; no Pallas counterpart).

``window_attention(qkv, table, window, shift, windows)`` computes, for
every window of a block's padded, rolled and partitioned token grid and
every head,

    softmax(q k^T * scale + B[rel(i, j)] + M(i, j)) v

where ``qkv`` is the qkv linear's output as it lies, (B * nW, N, 3, heads,
16): per window its N = wd * wh * ww tokens in (z, y, x) order, the
windows in (batch, z, y, x) order over ``windows`` = (nwd, nwh, nww) a
block. ``scale`` is 16^-0.5. ``B`` is ``table`` ((2 * 7 - 1)^3, heads),
indexed by ``((dz + 6) * 13 + dy + 6) * 13 + dx + 6`` over the window's own
coordinates, a shrunk window's too; ``M`` is -100 between tokens of
different shift regions (Swin's mask: by ``shift`` along each axis, the
last ``w - s`` and last ``s`` positions of the rolled, padded grid are
regions of their own; an axis of shift 0 is one region) and 0 otherwise.
The result is (B * nW, N, heads * 16) in qkv's dtype, the proj linear's
input.

* A CUDA tensor launches the kernel, which takes bf16 ``qkv`` of head dim
  16, a float32 ``table`` of 13^3 rows (window 7) and windows of at most
  384 tokens, or raises; it reads the table and the geometry alone, never a
  per-pair bias or mask. A CPU tensor takes :func:`window_attention_plain`.
  ``.launches`` counts the kernel's launches.
* :func:`window_attention_plain` — the twin, on any device and dtype: the
  scores and the softmax materialised in float32, P rounded to qkv's dtype
  for P v, summed in float32 and divided by the float32 row sum, as the
  kernel does (float64 stays float64). Its relative-position index and
  region ids are built once a geometry and device (:func:`relative_index`,
  :func:`region_ids`); :func:`bias_and_mask` gives them as dense tensors.
"""

from __future__ import annotations

import functools

import torch

from tpuseg_torch.ops import _build

HEAD_DIM = 16
WINDOW = 7                      # the table's window: 13^3 rows
MAX_TOKENS = 384                # the kernel's K, V and codes fit 48 KB
MASK_VALUE = -100.0


def table_side(table: torch.Tensor) -> int:
    """The side 2w - 1 of a relative-position table of (2w - 1)^3 rows."""
    side = round(table.shape[0] ** (1 / 3))
    if side ** 3 != table.shape[0] or side % 2 == 0:
        raise ValueError(f"a relative-position table has (2w - 1)^3 rows; "
                         f"got {tuple(table.shape)}")
    return side


@functools.lru_cache(maxsize=64)
def relative_index(window: tuple, side: int, device: torch.device
                   ) -> torch.Tensor:
    """(N, N) int64 table rows of each token pair of a ``window`` (wd, wh,
    ww): ``((dz + c) * side + dy + c) * side + dx + c``, c = (side - 1) / 2,
    from the tokens' own coordinates in the window."""
    c = (side - 1) // 2
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(w, device=device) for w in window], indexing="ij"),
        -1).reshape(-1, 3)
    d = grid[:, None, :] - grid[None, :, :] + c
    return (d[..., 0] * side + d[..., 1]) * side + d[..., 2]


def _axis_regions(n: int, w: int, s: int, device) -> torch.Tensor:
    pos = torch.arange(n * w, device=device)
    if s == 0:
        return torch.zeros_like(pos)
    return (pos >= n * w - w).long() + (pos >= n * w - s).long()


@functools.lru_cache(maxsize=64)
def region_ids(windows: tuple, window: tuple, shift: tuple,
               device: torch.device) -> torch.Tensor:
    """(nW, N) int64 shift region of each token of each window: the
    rolled, padded grid's region along each axis (module docstring)
    combined as ``(rz * 3 + ry) * 3 + rx``, windows in (z, y, x) order."""
    r = [_axis_regions(n, w, s, device)
         for n, w, s in zip(windows, window, shift)]
    ids = (r[0][:, None, None] * 3 + r[1][None, :, None]) * 3 \
        + r[2][None, None, :]
    (nd, nh, nw), (wd, wh, ww) = windows, window
    return (ids.view(nd, wd, nh, wh, nw, ww).permute(0, 2, 4, 1, 3, 5)
            .reshape(nd * nh * nw, wd * wh * ww))


def _check(qkv, table, window, shift, windows) -> tuple:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"window_attention takes qkv (B * nW, N, 3, heads, "
                         f"head_dim); got {tuple(qkv.shape)}")
    bw, n, _, heads, hd = qkv.shape
    nw = windows[0] * windows[1] * windows[2]
    if n != window[0] * window[1] * window[2] or bw % nw:
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)} is not "
                         f"whole windows {tuple(window)} of a "
                         f"{tuple(windows)} grid")
    if table.dim() != 2 or table.shape[1] != heads:
        raise ValueError(f"window_attention: table {tuple(table.shape)} for "
                         f"{heads} heads")
    if any(not 0 <= s < w for s, w in zip(shift, window)):
        raise ValueError(f"window_attention: shift {tuple(shift)} outside "
                         f"window {tuple(window)}")
    return bw, n, heads, hd


def bias_and_mask(table, window, shift, windows, dtype=torch.float32
                  ) -> tuple:
    """``(B, M)`` as tensors in ``dtype``: the relative-position bias of
    every token pair, (1, heads, N, N), and the shift mask of every window,
    (nW, 1, N, N), or None where nothing is shifted."""
    window, shift, windows = tuple(window), tuple(shift), tuple(windows)
    idx = relative_index(window, table_side(table), table.device)
    bias = table.to(dtype)[idx].permute(2, 0, 1)[None]
    if not any(shift):
        return bias, None
    ids = region_ids(windows, window, shift, table.device)
    mask = (ids[:, :, None] != ids[:, None, :]).to(dtype) * MASK_VALUE
    return bias, mask[:, None]


def window_attention_plain(qkv, table, window, shift, windows
                           ) -> torch.Tensor:
    """Twin of :func:`window_attention` in plain PyTorch (module
    docstring), on any device; float64 ``qkv`` computes in float64 (P's
    rounding is then none: the exact attention)."""
    window, shift, windows = tuple(window), tuple(shift), tuple(windows)
    bw, n, heads, hd = _check(qkv, table, window, shift, windows)
    dtype = qkv.dtype
    work = torch.promote_types(dtype, torch.float32)
    q, k, v = qkv.to(work).permute(2, 0, 3, 1, 4).unbind(0)  # (BW, h, N, d)
    bias, mask = bias_and_mask(table, window, shift, windows, work)
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5 + bias
    if mask is not None:
        nw = mask.shape[0]
        s = (s.view(bw // nw, nw, heads, n, n) + mask).view(bw, heads, n, n)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(dtype).to(work), v) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).reshape(bw, n, heads * hd).to(dtype)


def window_attention(qkv, table, window, shift, windows) -> torch.Tensor:
    """qkv (B * nW, N, 3, heads, 16) -> (B * nW, N, heads * 16) in qkv's
    dtype (module docstring). No autograd."""
    window, shift, windows = tuple(window), tuple(shift), tuple(windows)
    bw, n, heads, hd = _check(qkv, table, window, shift, windows)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, table, window, shift, windows)
    if qkv.dtype != torch.bfloat16 or hd != HEAD_DIM:
        raise ValueError(f"window_attention kernel computes bf16 heads of "
                         f"{HEAD_DIM}; got {qkv.dtype}, head dim {hd}")
    if table.dtype != torch.float32 \
            or table.shape[0] != (2 * WINDOW - 1) ** 3:
        raise ValueError(f"window_attention kernel reads a float32 table of "
                         f"{(2 * WINDOW - 1) ** 3} rows; got {table.dtype} "
                         f"{tuple(table.shape)}")
    if n > MAX_TOKENS or max(window) > WINDOW:
        raise ValueError(f"window_attention kernel takes windows of at most "
                         f"{WINDOW} a side and {MAX_TOKENS} tokens; got "
                         f"{tuple(window)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("window_attention kernel needs contiguous, 16-byte "
                         "aligned qkv")
    table = table.detach().contiguous()
    if table.device != qkv.device:
        raise ValueError(f"window_attention: table on {table.device}, qkv on "
                         f"{qkv.device}")
    out = torch.empty((bw, n, heads * hd), dtype=qkv.dtype,
                      device=qkv.device)
    err = _build.load().tpuseg_window_attention(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), bw, heads,
        *windows, *window, *shift, hd ** -0.5, _build.stream_ptr())
    _build.check(err, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
