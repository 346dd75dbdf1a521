"""SwinUNETR's ResBlock convolutions (``tpuseg_torch/ops/rconv.py``, R1) on
the CPU: the twin against the float64 convolution at every (ci, co) pair of
the net, the weight packing, the refusals, the 1x1x1 channel product, the
launch plan, and a torch model of the tensor-core body's index arithmetic
(``csrc/rconv.cu``): its boxes, halo windows and tap shifts, from the 96^3
level's shapes down to the 3^3 bottleneck's.
The kernels run only on the card: ``chip_smoke.py`` phase 25 holds them to
the twin there.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from tpuseg_torch.models import SwinUNETRConfig, build_swin_unetr, swin_unetr
from tpuseg_torch.ops import rconv as R

#: the (ci, co) pairs of SwinUNETR's 20 ResBlock 3x3x3 convs at feature 48,
#: with the side of a 96^3 block's level (tested at small sides)
NET_PAIRS = [(1, 48), (48, 48), (96, 96), (192, 192), (768, 768),
             (768, 384), (384, 384), (384, 192), (192, 96), (96, 48)]
#: the 20 calls of a tile batch of four 96^3 blocks: (ci, co, side)
NET_CALLS = [(1, 48, 96), (48, 48, 96), (48, 48, 48), (48, 48, 48),
             (96, 96, 24), (96, 96, 24), (192, 192, 12), (192, 192, 12),
             (768, 768, 3), (768, 768, 3), (768, 384, 6), (384, 384, 6),
             (384, 192, 12), (192, 192, 12), (192, 96, 24), (96, 96, 24),
             (96, 48, 48), (48, 48, 48), (96, 48, 96), (48, 48, 96)]
H100_SMS = 132


def _inputs(shape, co, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    w = torch.randn((co, shape[1], 3, 3, 3), generator=g) / math.sqrt(
        27 * shape[1])
    return x, w


def _exact(x, w):
    """The float64 convolution of the bf16 operands."""
    return F.conv3d(x.double(), w.to(torch.bfloat16).double(), padding=1)


def _ulp(v):
    """One bf16 ulp at each value (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _past_rounding(got, x, w, ulps=1.0):
    """The largest excess of |got - the float64 conv| over ``ulps`` bf16
    ulps of it plus float32's slack, 2^-20 of the sum of |products| (a
    float32 sum in another order than float64's, near a cancellation)."""
    exact = _exact(x, w)
    mag = F.conv3d(x.double().abs(), w.to(torch.bfloat16).double().abs(),
                   padding=1)
    err = (got.double() - exact).abs()
    return float((err - ulps * _ulp(exact) - 2.0 ** -20 * mag).max())


@pytest.mark.parametrize("ci,co", NET_PAIRS,
                         ids=[f"{a}-{b}" for a, b in NET_PAIRS])
def test_twin_is_the_conv_within_one_rounding(ci, co):
    """float32 sums of the bf16 operands, rounded once: within half a bf16
    ulp of the float64 sum, plus float32's slack (2^-20 of the sum of
    |products|)."""
    side = 3 if ci * co > 96 * 96 else 4
    x, w = _inputs((4, ci, side, side, side), co, seed=ci + co)
    got = R.rconv_plain(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (4, co) + (side,) * 3
    assert _past_rounding(got, x, w, 0.5) <= 0


def test_twin_on_a_ragged_side():
    x, w = _inputs((2, 48, 5, 7, 9), 48, seed=5)
    assert _past_rounding(R.rconv_plain(x, w), x, w, 0.5) <= 0


def test_a_cpu_tensor_takes_the_twin():
    x, w = _inputs((2, 16, 4, 5, 6), 48, seed=1)
    before = R.rconv.launches
    got = R.rconv(x, w)
    assert R.rconv.launches == before
    assert torch.equal(got.view(torch.int16),
                       R.rconv_plain(x, w).view(torch.int16))


def test_float32_twin_is_the_float32_conv():
    x, w = _inputs((1, 16, 4, 4, 4), 48, seed=2)
    x = x.float()
    torch.testing.assert_close(R.rconv(x, w), F.conv3d(x, w, padding=1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nc", [48, 96])
def test_packing_round_trips(nc):
    co = 192
    w = torch.randn(co, 32, 3, 3, 3)
    wp = R.pack_rconv_weights(w, nc)
    assert wp.shape == (co // nc, 2, 27, 2, nc, 8)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert torch.equal(R.unpack_rconv_weights(wp),
                       w.to(torch.bfloat16))


def test_packing_layout():
    """``out[j, c, t, g, o, k] = bf16(w[nc j + o, 16 c + 8 g + k, t])``,
    t = kd * 9 + kh * 3 + kw: per tap a K-major [2][nc][8] B operand."""
    w = torch.randn(96, 32, 3, 3, 3)
    wp = R.pack_rconv_weights(w, 48)
    flat = w.to(torch.bfloat16).reshape(96, 32, 27)
    g = torch.Generator().manual_seed(0)
    for _ in range(64):
        j, c, t, grp, o, k = (int(torch.randint(n, (1,), generator=g))
                              for n in (2, 2, 27, 2, 48, 8))
        assert wp[j, c, t, grp, o, k] == flat[48 * j + o, 16 * c + 8 * grp
                                              + k, t]


@pytest.mark.parametrize("bad", ["rank", "ci 8", "ci 24", "w shape",
                                 "w channels"])
def test_refuses_what_it_cannot_compute(bad):
    x, w = _inputs((1, 16, 3, 3, 3), 48)
    if bad == "rank":
        x = x[0]
    elif bad == "ci 8":
        x, w = _inputs((1, 8, 3, 3, 3), 48)
    elif bad == "ci 24":
        x, w = _inputs((1, 24, 3, 3, 3), 48)
    elif bad == "w shape":
        w = w[..., :2]
    else:
        w = w[:, :8]
    with pytest.raises(ValueError):
        R.rconv(x, w)
    with pytest.raises(ValueError):
        R.rconv_plain(x, w)


@pytest.mark.parametrize("which", ["x", "w"])
def test_refuses_autograd(which):
    x, w = _inputs((1, 16, 3, 3, 3), 48)
    x = x.float()
    (x if which == "x" else w).requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        R.rconv(x, w)
    with torch.no_grad():
        R.rconv(x, w)


@pytest.mark.parametrize("ci,co,bias", [(96, 48, False), (1, 48, False),
                                        (48, 2, True)],
                         ids=["conv3 96-48", "conv3 1-48", "head 48-2"])
def test_channel_product_is_the_1x1_conv(ci, co, bias):
    g = torch.Generator().manual_seed(ci)
    x = torch.randn(2, ci, 3, 4, 5, generator=g)
    w = torch.randn(co, ci, 1, 1, 1, generator=g)
    b = torch.randn(co, generator=g) if bias else None
    want = F.conv3d(x, w) + (0 if b is None else b.view(1, -1, 1, 1, 1))
    torch.testing.assert_close(R.channel_product(x, w, b), want, rtol=1e-5,
                               atol=1e-5)
    xb = x.to(torch.bfloat16)
    got = R.channel_product(xb, w).double()
    exact = F.conv3d(xb.double(), w.to(torch.bfloat16).double())
    assert float(((got - exact).abs() - _ulp(exact) - 2.0 ** -20
                  * exact.abs()).max()) <= 0


def test_every_resblock_conv_takes_the_wrappers(monkeypatch):
    """A net call: 20 3x3x3 convs through ``rconv`` (two a ResBlock), 7
    channel products (the six conv3 of the blocks that change width, and
    the head)."""
    calls = {"rconv": [], "channel_product": 0}

    def counted(x, w):
        calls["rconv"].append((x.shape[1], w.shape[0]))
        return R.rconv(x, w)

    def counted_cp(x, w, b=None):
        calls["channel_product"] += 1
        return R.channel_product(x, w, b)

    monkeypatch.setattr(swin_unetr, "rconv", counted)
    monkeypatch.setattr(swin_unetr, "channel_product", counted_cp)
    model = build_swin_unetr(SwinUNETRConfig(feature_size=16,
                                             num_heads=(1, 2, 4, 8),
                                             compute_dtype="float32"))
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32))
    want = sorted((16 * a // 48, 16 * b // 48) if a > 1 else (1, 16)
                  for a, b, _ in NET_CALLS)
    assert sorted(calls["rconv"]) == want
    assert calls["channel_product"] == 7


# ---- the launch plan -----------------------------------------------------

@pytest.mark.parametrize("ci,co,side", NET_CALLS,
                         ids=[f"{a}-{b}-{c}" for a, b, c in NET_CALLS])
def test_plan_of_every_net_call(ci, co, side):
    """Which body and launch each of the 20 calls takes on an H100: ci = 1
    on the CUDA cores; else the box body; the depth split only where the
    units fill under one wave (6^3 and 3^3: 32 units, 128 CTAs)."""
    plan = R.rconv_plan(4, ci, co, side, side, side, H100_SMS)
    if ci == 1:
        assert plan == R.Plan("ci1", co, 1, 0)
        return
    assert plan.body == "mma"
    assert plan.nc == (96 if co % 96 == 0 else 48)
    assert (ci // R.KC) % plan.split == 0
    assert (ci // R.KC) // plan.split >= min(R.MIN_CHUNKS, ci // R.KC)
    assert 1 <= plan.ctas <= H100_SMS
    assert plan.split == {3: 4, 6: 4}.get(side, 1)


def test_plan_refuses_what_no_body_takes():
    with pytest.raises(ValueError):
        R.rconv_plan(1, 16, 40, 8, 8, 8, H100_SMS)      # co not of 48
    with pytest.raises(ValueError):
        R.rconv_plan(1, 1, 96, 8, 8, 8, H100_SMS)       # ci 1, co over 48
    with pytest.raises(ValueError):
        R.rconv_plan(1, 8, 48, 8, 8, 8, H100_SMS)       # ci 8


# ---- models of the bodies' index arithmetic --------------------------------

def _box_model(x, w, nc_box):
    """The box body: for each box of (BZ, 8, BX) output voxels, the halo
    window from (z0 - 1, y0 - 1, x0 - 1), zero outside the volume; tile t
    (plane t // tiles_x, columns 8 (t % tiles_x)) at tap (kd, kh, kw) reads
    window plane t // tiles_x + kd, rows kh .. kh + 7, columns 8 (t %
    tiles_x) + kw .. + 7; float32 sums of the 27 taps, rounded once."""
    bz, by, bx = R.BOXES[nc_box]
    n, ci, d, h, wd = x.shape
    co = w.shape[0]
    wk = w.to(torch.bfloat16).float()
    xp = F.pad(x.float(), (1, bx + 1, 1, by + 1, 1, bz + 1))
    out = torch.zeros(n, co, d, h, wd)
    for z0 in range(0, d, bz):
        for y0 in range(0, h, by):
            for x0 in range(0, wd, bx):
                win = xp[:, :, z0:z0 + bz + 2, y0:y0 + by + 2, x0:x0 + bx + 2]
                acc = torch.zeros(n, co, bz, by, bx)
                for kd in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            a = win[:, :, kd:kd + bz, kh:kh + by, kw:kw + bx]
                            acc += torch.einsum("ncdhw,oc->nodhw", a,
                                                wk[:, :, kd, kh, kw])
                zs, ys, xs = (min(bz, d - z0), min(by, h - y0),
                              min(bx, wd - x0))
                out[:, :, z0:z0 + zs, y0:y0 + ys, x0:x0 + xs] = \
                    acc[:, :, :zs, :ys, :xs]
    return out.to(x.dtype)


@pytest.mark.parametrize("shape,co", [((2, 16, 5, 11, 20), 48),
                                      ((1, 32, 9, 8, 8), 96),
                                      ((2, 16, 3, 9, 17), 96),
                                      ((4, 16, 3, 3, 3), 96),
                                      ((4, 16, 6, 6, 6), 192),
                                      ((3, 32, 5, 7, 11), 192),
                                      ((2, 16, 12, 12, 12), 96)],
                         ids=["ragged 48", "aligned 96", "ragged 96", "3^3",
                              "6^3", "small ragged", "12^3"])
def test_box_model_is_the_conv(shape, co):
    """Every level's boxes, the small planes included, where a box is
    larger than the volume: the halo window zero outside it."""
    x, w = _inputs(shape, co, seed=shape[2])
    nc = R.rconv_plan(*shape[:2], co, *shape[2:], H100_SMS).nc
    assert _past_rounding(_box_model(x, w, nc), x, w, 0.5) <= 0
