"""MedNeXt (``tpuseg_torch/models/mednext.py``), its depthwise convs
(``tpuseg_torch/ops/dwconv.py``, D1) and N1's GroupNorm mode against the
plain float32 reference (the benchmark's ``perfbench/reference/mednext.py``)
on seeded random weights, at ``n_channels`` 4 with one block a stage, the
published expansions and kernel 5, on blocks of 32^3 and 16 x 32 x 48
(levels down to 2^3 and 1 x 2 x 3: every down block, every up block's
(2S - 1)^3 volume and low-end pad). A model of ``csrc/dwconv.cu``'s tiles,
staged boxes and index arithmetic is held to the twin; the D1 kernel runs
only on the card: ``chip_smoke.py`` phase 26 holds it to the twin there.

Tolerances. float32: 1e-4 of the logits' scale (their largest magnitude,
~10): the port sums in other orders than the reference (the 1x1x1 convs as
``torch.matmul`` against ``F.conv3d``, the transposed residual as a product
on the even positions against ``conv_transpose3d``), each a few float32
ulps, over ~20 layers (measured 6e-6). bf16 against the float32 reference:
mean absolute error under 0.04 and worst under 0.5: every op rounds to 8
significant bits (2^-9 relative), GroupNorm rescales the errors back to
the activations' size at each of ~20 layers and the residual sums carry
them on (measured 0.013 and 0.17 at logits up to ~11).
"""

import ast
import dataclasses
import importlib.util
import math
import sys
import warnings
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from tpuseg_torch.core import Config, InferConfig, PostprocConfig
from tpuseg_torch.data import synthesize_volume
from tpuseg_torch.infer import make_infer_fn
from tpuseg_torch.infer.pipeline import make_infer_stages
from tpuseg_torch.models import MedNeXt, MedNeXtConfig, build_mednext
from tpuseg_torch.models import mednext as mednext_module
from tpuseg_torch.models.mednext import Block
from tpuseg_torch.ops.dwconv import dwconv, dwconv_plain, out_side
from tpuseg_torch.ops.instnorm import (instance_norm_lrelu,
                                       instance_norm_lrelu_plain)
from tpuseg_torch.ops.mlp import fused_mlp
from tpuseg_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"in_channels": 1, "out_channels": 2, "n_channels": 4,
         "exp_r": [3, 4, 8, 8, 8, 8, 8, 4, 3],
         "block_counts": [1] * 9, "kernel_size": 5,
         "compute_dtype": "float32", "param_dtype": "float32"}
PUBLISHED = dict(SMALL, n_channels=32, block_counts=[3, 4, 8, 8, 8, 8, 8, 4, 3])
BLOCKS = [(1, 32, 32, 32), (2, 16, 32, 48)]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_PATH = ROOT / "perfbench" / "reference" / "mednext.py"
REF = _load(REF_PATH, "mednext_reference")
#: the ``model`` keys the program's config takes; float32 parameters are
#: its constant
FIELDS = {f.name for f in dataclasses.fields(MedNeXtConfig)}


def _config(model: dict, **kw) -> MedNeXtConfig:
    return MedNeXtConfig(**{k: v for k, v in dict(model, **kw).items()
                            if k in FIELDS})


def _arch():
    """The benchmark's architecture file (``perfbench/arch/mednext.py``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import cells

    return cells.load_arch("mednext")


def _model(dtype="float32", seed=3):
    """Seeded weights with biases and GroupNorm affines moved off their
    initial values, so that each of them counts."""
    model = build_mednext(_config(SMALL, compute_dtype=dtype), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def float32_model():
    return _model()


def _scale_close(got, want, rel):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("shape", BLOCKS, ids=lambda s: "x".join(map(str, s)))
def test_float32_port_is_the_reference(shape, float32_model):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(7))
    p = dict(float32_model.state_dict())
    with torch.no_grad():
        got = float32_model(x)
        want = REF.forward(p, x, SMALL)
    for k in ("fg_logits", "peak_logits"):
        assert got[k].dtype == torch.float32 and got[k].shape == shape
        _scale_close(got[k], want[k], 1e-4)


@pytest.mark.parametrize("shape", BLOCKS, ids=lambda s: "x".join(map(str, s)))
def test_bf16_port_is_near_the_reference(shape, float32_model):
    model = _model("bfloat16")
    model.load_state_dict(float32_model.state_dict())
    x = torch.rand(shape, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got = model(x[:, None])
        want = REF.forward(dict(float32_model.state_dict()), x, SMALL)
    for k in ("fg_logits", "peak_logits"):
        gap = (got[k] - want[k]).abs()
        assert got[k].dtype == torch.float32
        assert float(gap.mean()) < 0.04 and float(gap.max()) < 0.5, k


def test_block_sides_must_be_multiples_of_16(float32_model):
    with pytest.raises(ValueError, match="multiples of 16"):
        float32_model(torch.zeros(1, 32, 40, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_depthwise_conv_and_norm_takes_the_wrappers(dtype,
                                                          monkeypatch):
    """The small net's 17 depthwise convs (a block a stage, four down,
    four up) call ``dwconv`` in their three forms, and each GroupNorm calls N1's
    wrapper with its affine, no residual and slope 1, whatever the dtype:
    on the CPU the wrappers run their twins, on the card the kernels, which
    refuse float32 (D1) rather than give way to the twins there."""
    forms, norms = [], []

    def counted_dw(x, w, b, stride=1, transposed=False):
        forms.append((stride, transposed, x.dtype))
        return dwconv(x, w, b, stride, transposed)

    def counted_norm(a, r=None, norm_r=False, weight=None, bias=None,
                     slope=0.01):
        norms.append((r, weight is not None, bias is not None, slope))
        return instance_norm_lrelu(a, r, norm_r, weight, bias, slope)

    monkeypatch.setattr(mednext_module, "dwconv", counted_dw)
    monkeypatch.setattr(mednext_module, "instance_norm_lrelu", counted_norm)
    with torch.no_grad():
        _model(dtype)(torch.zeros(1, 32, 32, 32))
    dt = getattr(torch, dtype)
    assert forms == ([(1, False, dt)] + [(2, False, dt), (1, False, dt)] * 4
                     + [(2, True, dt), (1, False, dt)] * 4)
    assert norms == [(None, True, True, 1.0)] * 17


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_block_mlp_takes_the_wrapper(dtype, monkeypatch):
    """Each of the small net's 17 blocks (a block a stage, four down, four
    up) calls ``fused_mlp`` once, with conv2's and conv3's weights and its
    residual: the block's input itself in a plain block, ``res(x)`` of the
    output's shape in a down or up block, whatever the dtype (on the CPU
    the twin, on the card the kernel)."""
    calls, entered = [], []

    def counted(a, w2, b2, w3, b3, r=None):
        calls.append((a.shape[1], w2.shape[0], w3.shape[0], a.dtype, r))
        return fused_mlp(a, w2, b2, w3, b3, r)

    monkeypatch.setattr(mednext_module, "fused_mlp", counted)
    model = _model(dtype)
    for blk in model.modules():
        if isinstance(blk, Block):
            blk.register_forward_pre_hook(
                lambda mod, args: entered.append((mod.kind, args[0])))
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32))
    assert len(calls) == len(entered) == 17
    w = [4 * 2 ** i for i in range(5)]
    r = SMALL["exp_r"]
    want = ([(4, 4 * r[0], 4)]
            + [x for i in range(4) for x in (
                (w[i], w[i] * r[i + 1], w[i + 1]),
                (w[i + 1], w[i + 1] * r[i + 1], w[i + 1]))]
            + [x for i in reversed(range(4)) for x in (
                (w[i + 1], w[i + 1] * r[8 - i], w[i]),
                (w[i], w[i] * r[8 - i], w[i]))])
    assert [c[:3] for c in calls] == want
    for (ci, e, co, dt, res), (kind, x) in zip(calls, entered):
        assert dt == getattr(torch, dtype)
        if kind == "block":
            assert res is x
        else:
            assert res is not None and res.shape[1] == co and res is not x


# ------------------------------------------------------------------- D1

FORMS = [(1, False), (2, False), (2, True)]
RAGGED = [(2, 3, 7, 9, 11), (2, 2, 5, 13, 19), (1, 3, 1, 2, 3)]


def _dw_inputs(shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g).to(dtype)
    w = torch.randn((c, 1, 5, 5, 5), generator=g) / 11.2
    b = 0.1 * torch.randn((c,), generator=g)
    return x, w, b


@pytest.mark.parametrize("stride,transposed", FORMS,
                         ids=["stride1", "stride2", "transposed"])
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_twin_is_the_grouped_conv_in_float64(shape, stride, transposed):
    """The twin (float32) against the library's grouped conv in float64 on
    the same operands: float32 sums of 125 terms, 1e-5 of their scale;
    sides kept, halved (rounded up) or 2S - 1."""
    x, w, b = _dw_inputs(shape)
    got = dwconv_plain(x, w, b, stride, transposed)
    fn = F.conv_transpose3d if transposed else F.conv3d
    want = fn(x.double(), w.double(), b.double(), stride=stride, padding=2,
              groups=shape[1])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert list(got.shape[2:]) == [out_side(s, stride, transposed)
                                   for s in shape[2:]]
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_transposed_form_gives_sides_2s_minus_1():
    assert [out_side(s, 2, True) for s in (1, 8, 64)] == [1, 15, 127]
    assert [out_side(s, 2, False) for s in (1, 7, 128)] == [1, 4, 64]
    x, w, b = _dw_inputs((1, 2, 8, 4, 3))
    assert dwconv(x, w, b, 2, True).shape == (1, 2, 15, 7, 5)


@pytest.mark.parametrize("stride,transposed", FORMS,
                         ids=["stride1", "stride2", "transposed"])
def test_bf16_twin_rounds_once(stride, transposed):
    """bf16: the twin is the float32 sum of the bf16 operands (the weight
    and bias rounded to bf16) rounded once: within half a bf16 ulp of the
    float64 value plus float32's slack."""
    x, w, b = _dw_inputs((2, 3, 9, 10, 12), seed=1, dtype=torch.bfloat16)
    got = dwconv_plain(x, w, b, stride, transposed)
    assert got.dtype == torch.bfloat16
    fn = F.conv_transpose3d if transposed else F.conv3d
    want = fn(x.double(), w.bfloat16().double(), b.bfloat16().double(),
              stride=stride, padding=2, groups=3)
    e = torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126)))
    assert float(((got.double() - want).abs() - torch.exp2(e - 8)).max()) \
        <= 1e-5


@pytest.mark.parametrize("stride,transposed", FORMS,
                         ids=["stride1", "stride2", "transposed"])
def test_a_cpu_tensor_takes_the_twin(stride, transposed):
    x, w, b = _dw_inputs((2, 3, 6, 7, 8), dtype=torch.bfloat16)
    before = dwconv.launches
    assert torch.equal(dwconv(x, w, b, stride, transposed),
                       dwconv_plain(x, w, b, stride, transposed))
    assert dwconv.launches == before


@pytest.mark.parametrize("bad", ["float32 on the card", "not contiguous",
                                 "weight shape", "bias shape", "stride 3",
                                 "transposed stride 1", "not 5-d",
                                 "bf16 weight"])
def test_dwconv_refuses_what_it_cannot_compute(bad):
    """Refused on every device before anything launches; the meta device
    stands in for the card (it is not the CPU, so it takes the kernel's
    route)."""
    x, w, b = _dw_inputs((2, 3, 6, 7, 8), dtype=torch.bfloat16)
    x, w, b = (t.to("meta") for t in (x, w, b))
    stride, transposed = 1, False
    if bad == "float32 on the card":
        x = x.float()
    elif bad == "not contiguous":
        x = x.transpose(3, 4)
    elif bad == "weight shape":
        w = w[:, :, :3, :3, :3]
    elif bad == "bias shape":
        b = b[:2]
    elif bad == "stride 3":
        stride = 3
    elif bad == "transposed stride 1":
        transposed = True
    elif bad == "bf16 weight":
        w = w.bfloat16()
    else:
        x = x[0]
    with pytest.raises(ValueError):
        dwconv(x, w, b, stride, transposed)


@pytest.mark.parametrize("which", ["x", "w"])
def test_dwconv_refuses_autograd(which):
    x, w, b = _dw_inputs((1, 2, 5, 5, 5))
    (x if which == "x" else w).requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        dwconv(x, w, b)
    with torch.no_grad():
        dwconv(x, w, b)


# ---- a model of csrc/dwconv.cu's tiles, boxes and indexing ---------------

V = 4


def _s1_tile(width):
    """``launch_form``'s stride-1 tile by the width: (TZ, TY, TX, ZR)."""
    if width > 16:
        return 8, 16, 32, 4
    if width > 8:
        return 8, 16, 16, 4
    return 8, 8, 8, 4


def _round4(n):
    return (n + 3) // 4 * 4


def _stage(xp, origin, dims):
    """A plane's input box at ``origin`` (z, y, x) of ``dims``, zero outside
    the plane, as ``stage`` fills it."""
    box = torch.zeros(dims, dtype=torch.float64)
    src = [slice(max(o, 0), min(o + n, s))
           for o, n, s in zip(origin, dims, xp.shape)]
    dst = [slice(a.start - o, a.stop - o) for a, o in zip(src, origin)]
    if all(a.stop > a.start for a in src):
        box[tuple(dst)] = xp[tuple(src)]
    return box


def model_dwconv(x, w, b, stride):
    """Forms 0 and 1 as ``dwconv_kernel`` computes them: per tile of a
    plane, the staged box; per thread (tz, ty, vx), ZR planes x V columns of
    sums over the rows it reads (``box[tz ZR S + iz][ty S + dy][vx V S +
    j]``, j < RL), taps ``dz = iz - S zo``; each output written by one
    thread, where it lies in the volume. Float64 sums, so the indexing and
    not the rounding is what is held."""
    s = stride
    n, c, d, h, wd = x.shape
    od, oh, ow = (out_side(t, s, False) for t in (d, h, wd))
    tz_, ty_, tx_, zr = _s1_tile(wd) if s == 1 else (4, 8, 16, 1)
    rl = _round4((V - 1) * s + 5)
    bz, by = (tz_ - 1) * s + 5, (ty_ - 1) * s + 5
    px = _round4((tx_ - V) * s + rl)
    zin = (zr - 1) * s + 5
    out = torch.full((n, c, od, oh, ow), float("nan"), dtype=torch.float64)
    written = torch.zeros((od, oh, ow), dtype=torch.int64)
    ops = x.double().reshape(n * c, d, h, wd)
    taps = w.double().reshape(c, 5, 5, 5)
    tz = torch.arange(tz_ // zr).view(-1, 1, 1)
    ty = torch.arange(ty_).view(1, -1, 1)
    vx = torch.arange(tx_ // V).view(1, 1, -1)
    cols = s * torch.arange(V)
    for p in range(n * c):
        for z0 in range(0, od, tz_):
            for y0 in range(0, oh, ty_):
                for x0 in range(0, ow, tx_):
                    box = _stage(ops[p], (s * z0 - 2, s * y0 - 2, s * x0 - 2),
                                 (bz, by, px))
                    acc = torch.full((tz_ // zr, ty_, tx_ // V, zr, V),
                                     float(b[p % c]), dtype=torch.float64)
                    for iz in range(zin):
                        for dy in range(5):
                            row = torch.stack(
                                [box[tz * zr * s + iz, ty * s + dy,
                                     vx * V * s + j] for j in range(rl)], -1)
                            for zo in range(zr):
                                dz = iz - s * zo
                                if not 0 <= dz < 5:
                                    continue
                                for dx in range(5):
                                    acc[..., zo, :] += (row[..., cols + dx]
                                                        * taps[p % c, dz, dy,
                                                               dx])
                    for zo in range(zr):
                        for v in range(V):
                            gz, gy, gx = torch.broadcast_tensors(
                                z0 + tz * zr + zo, y0 + ty, x0 + vx * V + v)
                            keep = (gz < od) & (gy < oh) & (gx < ow)
                            idx = (gz[keep], gy[keep], gx[keep])
                            out[p // c, p % c][idx] = acc[..., zo, v][keep]
                            if p == 0:
                                written[idx] += 1
    assert bool((written == 1).all()), "an output written twice or never"
    return out


def model_dwconv_t(x, w, b):
    """Form 2 as ``dwconv_t_kernel`` computes it: per tile (4, 4, 16) of
    the input grid, the box around it; per thread (input position m), the
    27 inputs at m - 1 + (a, b, c) and its 8 outputs 2m + p, taps k = p, p
    + 2, ... from input ``1 + (p + 2 - k) / 2``; outputs at 2S - 1 and past
    it are dropped."""
    n, c, d, h, wd = x.shape
    od, oh, ow = 2 * d - 1, 2 * h - 1, 2 * wd - 1
    mz_, my_, mx_ = 4, 4, 16
    out = torch.full((n * c, od, oh, ow), float("nan"), dtype=torch.float64)
    written = torch.zeros((od, oh, ow), dtype=torch.int64)
    ops = x.double().reshape(n * c, d, h, wd)
    taps = w.double().reshape(c, 5, 5, 5)
    for p in range(n * c):
        for z0 in range(0, d, mz_):
            for y0 in range(0, h, my_):
                for x0 in range(0, wd, mx_):
                    box = _stage(ops[p], (z0 - 1, y0 - 1, x0 - 1),
                                 (mz_ + 2, my_ + 2, _round4(mx_ + 2)))
                    for lz in range(mz_):
                        for ly in range(my_):
                            for lx in range(mx_):
                                mz, my, mx = z0 + lz, y0 + ly, x0 + lx
                                if mz >= d or my >= h or mx >= wd:
                                    continue
                                inp = box[lz:lz + 3, ly:ly + 3, lx:lx + 3]
                                for pz in range(2):
                                    for py in range(2):
                                        for pxx in range(2):
                                            o = (2 * mz + pz, 2 * my + py,
                                                 2 * mx + pxx)
                                            acc = float(b[p % c])
                                            for kz in range(pz, 5, 2):
                                                for ky in range(py, 5, 2):
                                                    for kx in range(pxx, 5, 2):
                                                        acc += float(
                                                            inp[1 + (pz + 2 - kz) // 2,
                                                                1 + (py + 2 - ky) // 2,
                                                                1 + (pxx + 2 - kx) // 2]
                                                            * taps[p % c, kz, ky, kx])
                                            if o[0] < od and o[1] < oh \
                                                    and o[2] < ow:
                                                out[p][o] = acc
                                                if p == 0:
                                                    written[o] += 1
    assert bool((written == 1).all()), "an output written twice or never"
    return out.view(n, c, od, oh, ow)


@pytest.mark.parametrize("shape", [(1, 2, 9, 18, 37), (2, 1, 3, 5, 17),
                                   (1, 1, 11, 3, 9), (1, 1, 2, 9, 5)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_model_is_the_twin(shape, stride):
    """Every stride-1 tile width (32, 16, 8), ragged tiles on each axis,
    the stride-2 tile: the model's float64 sums against the float32 twin
    within float32's slack."""
    x, w, b = _dw_inputs(shape, seed=2)
    got = model_dwconv(x, w, b, stride)
    want = dwconv_plain(x, w, b, stride).double()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 5, 6, 19), (1, 1, 1, 2, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_transposed_kernel_model_is_the_twin(shape):
    x, w, b = _dw_inputs(shape, seed=3)
    got = model_dwconv_t(x, w, b)
    want = dwconv_plain(x, w, b, 2, True).double()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("px", [12, 20, 36])
def test_staging_runs_cover_each_box_row(px):
    """``stage``'s runs of 8 elements, from the row's first x rounded down
    to a multiple of 8 (``RUNS = (PX + 14) / 8`` of them), put every column
    of a box row in place once, whatever the row's first x (negative at
    the volume's low edge)."""
    runs = (px + 14) // 8
    for x0 in range(-9, 50):
        xa = x0 // 8 * 8
        off = x0 - xa
        cols = [8 * k + q - off for k in range(runs) for q in range(8)]
        assert sorted(j for j in cols if 0 <= j < px) == list(range(px))
        assert all((xa + 8 * k) % 8 == 0 for k in range(runs))


def test_kernel_source_holds_the_models_tiles():
    """The tiles, the stride-2 form's and the transposed form's, as the
    source launches them: change the models with ``csrc/dwconv.cu``."""
    src = (ROOT / "tpuseg_torch" / "csrc" / "dwconv.cu").read_text()
    for tile in ("launch<1, 8, 16, 32, 4>", "launch<1, 8, 16, 16, 4>",
                 "launch<1, 8, 8, 8, 4>", "launch<2, 4, 8, 16, 1>",
                 "constexpr int MZ = 4, MY = 4, MX = 16;",
                 "constexpr int V = 4;", "if (W > 16)", "if (W > 8)",
                 "constexpr int RUNS = (PX + 14) / 8;",
                 "-((7 - x0) / 8) * 8"):
        assert tile in src, tile


# ------------------------------------------------------------- N1's GN mode

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 11), (1, 4, 1, 1, 2),
                                   (2, 2, 9, 9, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_mode_is_group_norm(shape, dtype):
    """The GroupNorm mode (weight, bias, no residual, slope 1) on the CPU
    is ``F.group_norm`` with one group a channel: in float32 within float32
    ulps of the library's float32 call; in bf16 the float32 value rounded
    once, so within half a bf16 ulp of it."""
    g = torch.Generator().manual_seed(5)
    a = (3 * torch.randn(shape, generator=g) + 1).to(dtype)
    weight = 1 + 0.3 * torch.randn(shape[1], generator=g)
    bias = 0.3 * torch.randn(shape[1], generator=g)
    got = instance_norm_lrelu(a, weight=weight, bias=bias, slope=1.0)
    want = F.group_norm(a.float(), shape[1], weight, bias, 1e-5)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want.to(dtype))
    assert torch.equal(got, instance_norm_lrelu_plain(
        a, weight=weight, bias=bias, slope=1.0))


def test_group_norm_mode_with_residual_and_slope():
    """The mode composes with R and a slope as the module docstring writes:
    lrelu(GN(a) + R)."""
    g = torch.Generator().manual_seed(6)
    a, r = torch.randn((2, 3, 4, 5, 6), generator=g).unbind(0)[0][None], \
        torch.randn((1, 3, 4, 5, 6), generator=g)
    weight, bias = torch.rand(3, generator=g) + 0.5, torch.randn(3, generator=g)
    got = instance_norm_lrelu(a, r, weight=weight, bias=bias, slope=0.2)
    want = F.leaky_relu(F.group_norm(a, 3, weight, bias, 1e-5) + r, 0.2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_without_an_affine_the_calls_are_todays():
    """SwinUNETR's calls (no weight, the default slope) give bitwise what
    the composition gave before the mode existed."""
    g = torch.Generator().manual_seed(7)
    a, r = (torch.randn((2, 3, 5, 6, 7), generator=g).bfloat16()
            for _ in range(2))
    for rr, norm_r in ((None, False), (r, False), (r, True)):
        y = torch.instance_norm(a, None, None, None, None, True, 0.0, 1e-5,
                                True)
        if rr is not None:
            y = y + (torch.instance_norm(rr, None, None, None, None, True,
                                         0.0, 1e-5, True) if norm_r else rr)
        assert torch.equal(instance_norm_lrelu(a, rr, norm_r),
                           F.leaky_relu(y, 0.01))


@pytest.mark.parametrize("bad", ["weight alone", "weight shape"])
def test_group_norm_mode_refuses_a_bad_affine(bad):
    a = torch.randn((1, 3, 4, 4, 4))
    weight, bias = torch.ones(3), torch.zeros(3)
    if bad == "weight alone":
        bias = None
    else:
        weight = torch.ones(2)
    with pytest.raises(ValueError, match="weight and bias"):
        instance_norm_lrelu(a, weight=weight, bias=bias, slope=1.0)


def test_group_norm_mode_refuses_autograd():
    a = torch.randn((1, 3, 4, 4, 4))
    weight = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        instance_norm_lrelu(a, weight=weight, bias=torch.zeros(3), slope=1.0)


# ------------------------------------------------------------- the blocks

def test_up_block_pads_low_and_its_residual_is_bias_at_odd_positions():
    """Up: the reference's up block equals the port's; the sum's first
    plane, row and column are the zero pad; the transposed 1x1x1 residual
    holds its bias alone at the odd positions (before the pad)."""
    torch.manual_seed(0)
    blk = Block(8, 4, 3, 5, "up").eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.2 * torch.randn(p.shape))
    p = {f"up.0.{k}": v for k, v in blk.state_dict().items()}
    x = torch.randn((2, 8, 3, 4, 5))
    with torch.no_grad():
        got = blk(x)
        want = REF._up(x, p, "up.0", 5, None)
        res = F.conv_transpose3d(x, p["up.0.res_conv.weight"],
                                 p["up.0.res_conv.bias"], stride=2)
    assert got.shape == want.shape == (2, 4, 6, 8, 10)
    _scale_close(got, want, 1e-5)
    assert bool((got[:, :, 0] == 0).all() and (got[:, :, :, 0] == 0).all()
                and (got[..., 0] == 0).all())
    bias = p["up.0.res_conv.bias"].view(1, -1, 1, 1, 1)
    for sl in ((slice(1, None, 2), slice(None), slice(None)),
               (slice(None), slice(1, None, 2), slice(None)),
               (slice(None), slice(None), slice(1, None, 2))):
        odd = res[(slice(None), slice(None)) + sl]
        assert torch.equal(odd, bias.expand_as(odd))


def test_down_block_is_the_references():
    torch.manual_seed(1)
    blk = Block(4, 8, 4, 5, "down").eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.2 * torch.randn(p.shape))
    p = {f"down.0.{k}": v for k, v in blk.state_dict().items()}
    x = torch.randn((2, 4, 6, 8, 10))
    with torch.no_grad():
        got = blk(x)
        want = REF._down(x, p, "down.0", 5, None)
    assert got.shape == (2, 8, 3, 4, 5)
    _scale_close(got, want, 1e-5)


def test_state_is_the_architecture_files():
    """Names and shapes equal ``perfbench/arch/mednext.state_shapes``, and
    the published net (MedNeXt-L, kernel 5, in 1, out 2) has 62,992,898
    parameters."""
    arch = _arch()
    for model in (SMALL, PUBLISHED):
        with torch.device("meta"):
            net = MedNeXt(_config(model))
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert list(shapes.items()) == list(arch.state_shapes(model).items())
    assert sum(math.prod(s) for s in shapes.values()) == 62_992_898
    assert sum(p.numel() for p in net.parameters()) == 62_992_898


def _infer_cfg():
    return Config(
        infer=InferConfig(tile=(32, 32, 32), halo=0, tile_batch=2,
                          compute_dtype="float32"),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16))


def test_infer_fn_gives_the_eager_stages_labels(float32_model):
    """The normal path, on the CPU eager on every call, with no warning
    about a receptive field (the net has no U-Net ``features``), equals
    its own two stages; the sweep's net calls mark the model's stages,
    ``mednext.full`` twice a call."""
    vol = torch.from_numpy(synthesize_volume(
        shape=(32, 64, 64), num_instances=6, radius_range=(3.0, 5.0),
        noise=0.05, seed=2).image)
    cfg = _infer_cfg()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        infer = make_infer_fn(float32_model, cfg)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        with profiling.span("test.call"):
            labels = infer(vol)
    names = [s.name for s in sorted(profiling.RECORDER.stages,
                                    key=lambda s: s.index)]
    profiling.reset()
    # nothing in the body reads the host: on the card the call captures
    # (a CPU tensor runs it eagerly)
    assert infer.mode == "captured"
    _, stage_net, stage_post = make_infer_stages(float32_model, cfg)
    assert torch.equal(labels, stage_post(stage_net(vol)))
    assert labels.dtype == torch.int32 and labels.shape == vol.shape
    per_batch = ["net", "mednext.full", "mednext.deep", "mednext.full",
                 "tile_glue"]
    assert names == (["norm", "tile_glue"] + per_batch * 2
                     + ["watershed", "filter"])


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_only_torch():
    assert _imports(REF_PATH) == {"__future__", "torch"}


@pytest.mark.parametrize("path", [
    "tpuseg_torch/models/mednext.py", "tpuseg_torch/ops/dwconv.py",
    "tpuseg_torch/ops/mlp.py", "perfbench/arch/mednext.py"])
def test_port_and_seam_import_no_jax(path):
    names = _imports(ROOT / path)
    assert not names & {"jax", "jaxlib", "flax", "tpuseg"}
