"""The decoder's upsample-and-conv with its skip concatenation
(``tpuseg_torch/ops/upconv.py``): the plain twin against the module path
(``Up.up`` and ``Up.forward``'s concatenation), the wrapper's routes and
refusals, the fused eval apply's route by dtype, and a model of the CUDA
kernel's tiles, staged window, shifts, epilogue words and skip pieces
(``csrc/upconv.cu``) against the twin. The kernel itself runs only on the
card: ``chip_smoke.py`` phase 22 holds it to the twin there.

float32: the twin sums the same products in another order, rtol/atol 1e-5.
bf16: one ulp at the first rounding point (the f32 sum rounded to bf16; the
two orders can straddle a rounding boundary), and the second (the bias add
in bf16) exact given the first. A sum that cancels carries the f32 sums' own
error, which scales with the products and not with the sum: one ulp is taken
of the value's magnitude floored at 2^-12 of the largest (up2's sum of
-7.6e-6 among sums up to ~3 read 8.9e-8 apart, 3 of its own ulps).
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuseg_torch.core import ModelConfig
from tpuseg_torch.models import build_model
from tpuseg_torch.models.blocks import Up
from tpuseg_torch.models.fused_eval import (fused_apply_supported,
                                            make_fused_apply)
from tpuseg_torch.ops import upconv
from tpuseg_torch.ops.upconv import (kernel_takes, pack_upconv_weights,
                                     rows_per_cta, unpack_upconv_weights,
                                     upsample_conv_cat,
                                     upsample_conv_cat_plain)

LEVELS = [(256, 128), (128, 64), (64, 32)]     # up2, up1, up0 of the U-Net
SHAPES = [(1, (3, 5, 7)), (2, (2, 4, 6))]      # (batch, coarse d, h, w)


def _inputs(ci, co, batch, dhw, seed=0):
    g = torch.Generator().manual_seed(seed)
    d, h, w = dhw
    x = torch.randn((batch, ci, d, h, w), generator=g)
    skip = torch.randn((batch, co, 2 * d, 2 * h, 2 * w), generator=g)
    up = Up(ci, co)
    with torch.no_grad():
        up.up_conv.weight.copy_(torch.randn(up.up_conv.weight.shape,
                                            generator=g) / (8 * ci) ** 0.5)
        up.up_conv.bias.copy_(torch.randn((co,), generator=g))
    return x, skip, up


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significant bits), |v| floored
    at 2^-12 of its largest (module docstring)."""
    v = v.float().abs()
    floor = max(float(v.max()) * 2.0 ** -12, 2.0 ** -126)
    e = torch.floor(torch.log2(v.clamp(min=floor)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,dhw", SHAPES, ids=["3x5x7", "batch2"])
@pytest.mark.parametrize("ci,co", LEVELS, ids=["up2", "up1", "up0"])
def test_twin_equals_module_up_and_concat(ci, co, batch, dhw, dtype):
    dtype = getattr(torch, dtype)
    x, skip, up = _inputs(ci, co, batch, dhw)
    x, skip = x.to(dtype), skip.to(dtype)
    w, b = up.up_conv.weight, up.up_conv.bias
    wp = pack_upconv_weights(w)
    with torch.no_grad():
        got = upsample_conv_cat_plain(x, skip, wp, b)
        want = torch.cat([up.up(x), skip], dim=1)
    assert got.dtype == want.dtype == dtype
    assert got.shape == (batch, 2 * co, *(2 * s for s in dhw))
    assert torch.equal(got[:, co:], skip)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    # the rounding points: bf16(sum) within one ulp, then the bias add exact
    zero = torch.zeros_like(b)
    with torch.no_grad():
        pre_got = upsample_conv_cat_plain(x, skip, wp, zero)[:, :co]
        pre_want = F.conv3d(F.pad(F.interpolate(x, scale_factor=2,
                                                mode="nearest"),
                                  (0, 1, 0, 1, 0, 1)), w.to(dtype))
    gap = (pre_got.float() - pre_want.float()).abs()
    assert bool((gap <= _bf16_ulp(pre_want)).all()), float(gap.max())
    bias = b.to(dtype).view(1, -1, 1, 1, 1)
    assert torch.equal(got[:, :co], pre_got + bias)
    assert torch.equal(want[:, :co], pre_want + bias)


def test_pack_layout_and_its_inverse():
    w = torch.randn(64, 128, 2, 2, 2)
    p = pack_upconv_weights(w)
    assert p.shape == (2, 8, 16, 32, 8) and p.dtype == w.dtype
    assert p.is_contiguous()
    for j, t, g, o, k in [(0, 0, 0, 0, 0), (1, 5, 3, 17, 6),
                          (1, 7, 15, 31, 7)]:
        kd, kh, kw = t >> 2, (t >> 1) & 1, t & 1
        assert p[j, t, g, o, k] == w[32 * j + o, 8 * g + k, kd, kh, kw]
    assert torch.equal(unpack_upconv_weights(p), w)
    assert torch.equal(pack_upconv_weights(w.bfloat16()), p.bfloat16())
    with pytest.raises(ValueError):
        pack_upconv_weights(torch.randn(48, 64, 2, 2, 2))
    with pytest.raises(ValueError):     # the torch layout is not packed
        unpack_upconv_weights(w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cpu_route_takes_the_twin(dtype):
    dtype = getattr(torch, dtype)
    x, skip, up = _inputs(64, 32, 2, (3, 5, 7))
    x, skip = x.to(dtype), skip.to(dtype)
    wp = pack_upconv_weights(up.up_conv.weight.to(dtype))
    b = up.up_conv.bias.detach()
    before = upsample_conv_cat.launches
    got = upsample_conv_cat(x, skip, wp, b)
    assert upsample_conv_cat.launches == before
    assert torch.equal(got, upsample_conv_cat_plain(x, skip, wp, b))


def _meta(*shape, **kw):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta", **kw)


def _packed(co, ci):
    return pack_upconv_weights(torch.zeros(co, ci, 2, 2, 2,
                                           dtype=torch.bfloat16))


@pytest.mark.parametrize("case", ["x 4-d", "skip not 2x", "skip channels",
                                  "w channels", "w not packed",
                                  "x not contiguous", "skip not contiguous",
                                  "float32", "w float32",
                                  "ci not a multiple of 64"])
def test_wrapper_refuses(case):
    """Shapes are refused on every device; what only the kernel needs (bf16,
    contiguous, its channel counts) on a non-CPU tensor (meta here: shapes
    only, the refusal comes before any launch)."""
    x, skip = _meta(1, 64, 3, 5, 7), _meta(1, 32, 6, 10, 14)
    w, b = _packed(32, 64), torch.zeros(32)
    if case == "x 4-d":
        x = _meta(64, 3, 5, 7)
    elif case == "skip not 2x":
        skip = _meta(1, 32, 6, 10, 15)
    elif case == "skip channels":
        skip = _meta(1, 64, 6, 10, 14)
    elif case == "w channels":
        w = _packed(32, 32)
    elif case == "w not packed":
        w = torch.zeros(32, 64, 2, 2, 2, dtype=torch.bfloat16)
    elif case == "x not contiguous":
        x = _meta(1, 64, 3, 7, 5).transpose(3, 4)
    elif case == "skip not contiguous":
        skip = _meta(1, 32, 6, 14, 10).transpose(3, 4)
    elif case == "float32":
        x = x.float()
    elif case == "w float32":
        w = w.float()
    else:
        x, w = _meta(1, 48, 3, 5, 7), _packed(32, 48)
    with pytest.raises(ValueError):
        upsample_conv_cat(x, skip, w, b)
    if case.startswith(("x 4-d", "skip not 2x", "skip channels", "w ch",
                        "w not")):
        # the same shapes on the CPU
        with pytest.raises(ValueError):
            upsample_conv_cat(torch.empty(x.shape), torch.empty(skip.shape),
                              w, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_apply_routes_up_levels_by_dtype(monkeypatch, dtype):
    """bf16: all three Up levels through the wrapper (on the CPU its twin),
    never ``Up.up``; float32: ``Up.up`` for each, never the twin."""
    model = build_model(ModelConfig(features=(32, 64, 128, 256),
                                    compute_dtype=dtype), seed=1)
    calls, up_calls = [], []
    twin, module_up = upconv.upsample_conv_cat_plain, Up.up

    def counted_twin(x, skip, w, b):
        calls.append((x.shape[1], skip.shape[1]))
        return twin(x, skip, w, b)

    def counted_up(self, x):
        up_calls.append(x.shape[1])
        return module_up(self, x)

    monkeypatch.setattr(upconv, "upsample_conv_cat_plain", counted_twin)
    monkeypatch.setattr(Up, "up", counted_up)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 8, 16, 16), dtype=np.float32))
    out = make_fused_apply(model)(x)
    assert out["fg_logits"].shape == (1, 8, 16, 16)
    if dtype == "bfloat16":
        assert calls == [(256, 128), (128, 64), (64, 32)] and up_calls == []
    else:
        assert calls == [] and up_calls == [256, 128, 64]


# ---- a model of csrc/upconv.cu's indexing ---------------------------------

TILE, PITCH, KC, NC, THREADS = 64, 65, 64, 32, 256


def kernel_model(x, skip, wp, bias, rows):
    """``tpuseg_upsample_conv_cat`` CTA by CTA as the source computes it:
    the grid, the staged window as flat 16-byte words ([group][plane][row]
    [PITCH]) with zeros outside the volume, each (class, tap)'s A rows at
    the word shift (p & k), the packed B slices, the epilogue's words of the
    pw = 0 / 1 pair and the skip copy (16-byte vectors where W % 4 == 0,
    else 4-byte words). float32 sums; y starts as NaN so that an element no
    CTA writes shows."""
    n_, ci, D, H, W = x.shape
    co = wp.shape[0] * NC
    xf, wf, bf = x.float(), wp.float(), bias.float()
    y = torch.full((n_, 2 * co, 2 * D, 2 * H, 2 * W), float("nan"))
    w_tiles = -(-W // TILE)
    grid = (w_tiles * -(-H // rows), n_ * D, co // NC)
    for bx, by, nc in itertools.product(*map(range, grid)):
        w0, h0 = (bx % w_tiles) * TILE, (bx // w_tiles) * rows
        n, md = by // D, by % D
        for mh in range(h0, min(h0 + rows, H)):
            acc = torch.zeros(8, TILE, NC)
            for c in range(ci // KC):
                win = torch.zeros(KC // 8, 2 * 2 * PITCH, 8)
                for pl, r, col in itertools.product(range(2), range(2),
                                                    range(PITCH)):
                    gz, gy, gx = md + pl, mh + r, w0 + col
                    if gz < D and gy < H and gx < W:
                        win[:, pl * 2 * PITCH + r * PITCH + col] = xf[
                            n, c * KC:(c + 1) * KC, gz, gy, gx].view(-1, 8)
                for p, k in itertools.product(range(8), range(8)):
                    s = p & k
                    shift = (s >> 2) * 2 * PITCH + ((s >> 1) & 1) * PITCH + (
                        s & 1)
                    a = win[:, shift:shift + TILE].permute(1, 0, 2).reshape(
                        TILE, KC)
                    b = wf[nc, k, c * KC // 8:(c + 1) * KC // 8].permute(
                        0, 2, 1).reshape(KC, NC)
                    acc[p] += a @ b
            for q in range(4):
                pd, ph = q >> 1, q & 1
                for m in range(TILE):
                    mw = w0 + m
                    if mw >= W:
                        continue
                    for pw in range(2):
                        v = acc[2 * q + pw, m].bfloat16().float() + bf[
                            nc * NC:(nc + 1) * NC]
                        y[n, nc * NC:(nc + 1) * NC, 2 * md + pd, 2 * mh + ph,
                          2 * mw + pw] = v.bfloat16().float()
            if W % 4 == 0:      # 16-byte vectors: tid, piece i, half e
                tid, i, e = (t.reshape(-1) for t in torch.meshgrid(
                    torch.arange(THREADS), torch.arange(4), torch.arange(2),
                    indexing="ij"))
                ch, fr, fw = tid // 16 + 16 * e, i, 2 * w0 + 8 * (tid % 16)
                keep = fw < 2 * W
                ch, fr, fw = ch[keep], fr[keep], fw[keep]
                fw = (fw[:, None] + torch.arange(8)).reshape(-1)
                ch, fr = ch.repeat_interleave(8), fr.repeat_interleave(8)
            else:               # 4-byte words of 2 fine voxels
                u = torch.arange(4 * NC * TILE)
                word, ch, fr = u % TILE, (u // TILE) % NC, u // TILE // NC
                keep = w0 + word < W
                word, ch, fr = word[keep], ch[keep], fr[keep]
                fw = (2 * (w0 + word)[:, None] + torch.arange(2)).reshape(-1)
                ch, fr = ch.repeat_interleave(2), fr.repeat_interleave(2)
            idx = (n, nc * NC + ch, 2 * md + (fr >> 1), 2 * mh + (fr & 1), fw)
            y[(idx[0], co + idx[1], *idx[2:])] = skip[idx].float()
    return y


@pytest.mark.parametrize("ci,co,batch,dhw,rows", [
    (128, 64, 2, (2, 3, 70), 2),    # two pieces, two chunks, a ragged tile
    (64, 32, 1, (3, 5, 7), 1),      # odd extents: the pad edge on each axis
    (64, 32, 1, (2, 2, 100), 1),    # vectors of the skip, a ragged tile
    (64, 32, 1, (1, 1, 64), 8),     # one whole tile, rows beyond H
    (256, 128, 1, (2, 2, 20), 1)])  # four pieces, W % 8 != 0: the default
                                    # tile's up2 (8 x 20 x 20)
def test_kernel_model_equals_twin(ci, co, batch, dhw, rows):
    x, skip, up = _inputs(ci, co, batch, dhw, seed=3)
    x, skip = x.bfloat16(), skip.bfloat16()
    w, b = up.up_conv.weight.detach(), up.up_conv.bias.detach()
    wp = pack_upconv_weights(w.bfloat16())
    got = kernel_model(x, skip, wp, b.bfloat16(), rows)
    assert not bool(torch.isnan(got).any())
    want = upsample_conv_cat_plain(x, skip, wp, b).float()
    assert torch.equal(got[:, co:], want[:, co:])
    pre = upsample_conv_cat_plain(x, skip, wp, torch.zeros_like(b))[:, :co]
    gap = (got[:, :co] - want[:, :co]).abs()
    bound = _bf16_ulp(pre) + _bf16_ulp(want[:, :co])
    assert bool((gap <= bound).all()), float(gap.max())
    assert float((gap == 0).float().mean()) > 0.99


@pytest.mark.parametrize("features,dtype,ok", [
    ((32, 64, 128, 256), "bfloat16", True),
    ((32, 64, 128, 256, 320), "bfloat16", True),
    ((32, 64, 128, 256, 512), "bfloat16", False),   # up3's ci 512 > 320
    ((32, 96, 192), "bfloat16", False),             # up0's ci 96
    ((32, 64, 128, 256, 512), "float32", True),     # the module path
], ids=["c3", "ci-320", "ci-512", "ci-96", "ci-512-f32"])
def test_fused_apply_gate_holds_the_up_conv_widths(features, dtype, ok):
    """The bf16 fused apply runs every Up level on the kernel, so a width it
    does not take is refused when the apply is built, on every device."""
    cfg = ModelConfig(features=features, compute_dtype=dtype)
    assert fused_apply_supported(cfg) is ok
    if not ok:
        with pytest.raises(ValueError):
            make_fused_apply(build_model(cfg, seed=0))


def test_kernel_takes():
    for ci, co in LEVELS + [(320, 256)]:
        assert kernel_takes(ci, co)
    for ci, co in [(96, 32), (384, 256), (512, 256), (64, 48)]:
        assert not kernel_takes(ci, co)


def test_rows_per_cta():
    assert rows_per_cta(26112, 132) == 8        # up0 of a 96x272x512 block
    assert rows_per_cta(6528, 132) == 6         # up1
    assert rows_per_cta(1632, 132) == 1         # up2
    assert rows_per_cta(3, 132) == 1
