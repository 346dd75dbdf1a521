"""SwinUNETR's InstanceNorm, add and LeakyReLU (``tpuseg_torch/ops/instnorm.py``):
a model of the N1 kernel pair's arithmetic (``csrc/instnorm.cu``: the chunks
of a plane, each thread's 16-byte vectors and scalars, the exact statistics
of a vector, Chan's merges in the kernel's fixed order, the apply's merge of
the partials, the float32 expression rounded once) against the twin, today's
``torch.instance_norm`` / add / ``F.leaky_relu`` composition, and against
float64; the wrapper's CPU route, its refusals, and the ResBlock's use of it.
The kernel runs only on the card: ``chip_smoke.py`` phase 24 holds it to the
twin there.

The kernel's float operations are explicit round-to-nearest intrinsics (no
contracted multiply-add), and torch's float32 CPU ops round each op alike,
so the model repeats the kernel's arithmetic op for op.

Tolerances. float32 statistics of the same values in other orders differ by
float32 ulps of the mean and the deviation: a normalized value within 1e-5
of its float64 value, in units of 1 + the terms' magnitudes (|IN(a)| +
|R|); torch's CPU kernel leaves a one-voxel plane at up to ~2e-5 where the
value is 0, so the model and the twin agree within 1e-4. bf16: the model rounds once, so each value lies within half a bf16 ulp
of the float64 value plus that float32 slack; the twin rounds three times
(norm, add, activation), and its mean error is no smaller than the model's.
"""

import math
from collections import defaultdict

import pytest
import torch
import torch.nn.functional as F

from tpuseg_torch.models import build_swin_unetr, swin_unetr
from tpuseg_torch.models.swin_unetr import ResBlock, SwinUNETRConfig
from tpuseg_torch.ops import instnorm
from tpuseg_torch.ops.instnorm import (CHUNK, EPS, SLOPE, instance_norm_lrelu,
                                       instance_norm_lrelu_plain)

THREADS, WARPS = 256, 8
F32 = torch.float32
#: planes of 1 (a 32^3 block's bottleneck), 27 (a 96^3 block's), 1728, a
#: 96^3 block's full-resolution 884,736 (54 chunks), and sizes that are not
#: multiples of a 16-byte vector: 385 and 18,513 (two chunks, the second
#: ragged, planes starting off the vector grid)
SHAPES = [(3, 4, 1, 1, 1), (2, 5, 3, 3, 3), (1, 3, 12, 12, 12),
          (1, 2, 96, 96, 96), (2, 3, 5, 7, 11), (1, 2, 33, 33, 17)]
MODES = ["none", "x", "norm"]
DTYPES = [torch.float32, torch.bfloat16]


# ------------------------------------------------------------------ model

def _merge(a, b):
    """Chan's merge of b into a, elementwise over (count, mean, M2)
    tensors, as ``merge`` in the kernel: an empty b leaves a."""
    n = a[0] + b[0]
    d = b[1] - a[1]
    f = b[0] / n
    m = a[1] + d * f
    q = (a[2] + b[2]) + ((d * d) * a[0]) * f
    keep = b[0] == 0
    return tuple(torch.where(keep, x, y) for x, y in zip(a, (n, m, q)))


def _tree(s, width):
    """The shuffle-down tree over the last axis: lane 0's merge."""
    off = width // 2
    while off:
        s = _merge(tuple(t[..., :off] for t in s),
                   tuple(t[..., off:2 * off] for t in s))
        off //= 2
    return tuple(t[..., 0] for t in s)


def _empty(*shape):
    return tuple(torch.zeros(shape, dtype=F32) for _ in range(3))


def _span(g0: int, n: int, v: int) -> tuple:
    """A chunk's voxels as (head scalars, vectors, tail scalars): its first
    voxel's index in the tensor is g0."""
    head = min((v - g0 % v) % v, n)
    nv = (n - head) // v
    return head, nv, n - head - nv * v


def _vector_stats(x):
    """Count, mean and M2 of each row of V values: the sum in order, its
    mean, the squared deviations summed in order."""
    v = x.shape[-1]
    s = x[..., 0]
    for j in range(1, v):
        s = s + x[..., j]
    m = s * (1.0 / v)
    q = torch.zeros_like(m)
    for j in range(v):
        d = x[..., j] - m
        q = q + d * d
    return torch.full_like(m, float(v)), m, q


def _scalars(xs, count):
    """Threads 0..count-1 each take one voxel (count 1, M2 0)."""
    b = xs.shape[0]
    n = torch.zeros((b, THREADS), dtype=F32)
    m = torch.zeros((b, THREADS), dtype=F32)
    n[:, :count] = 1.0
    m[:, :count] = xs
    return n, m, torch.zeros_like(m)


def _chunk_stats(xs, head, nv, tail, v):
    """(B,) statistics of B chunks of one layout, each (B, n) float32, as a
    CTA of the statistics kernel merges them."""
    b = xs.shape[0]
    acc = _empty(b, THREADS)
    if head:
        acc = _merge(acc, _scalars(xs[:, :head], head))
    if nv:
        vs = _vector_stats(xs[:, head:head + nv * v].reshape(b, nv, v))
        rounds = -(-nv // THREADS)
        pad = rounds * THREADS - nv
        vs = tuple(F.pad(t, (0, pad)).view(b, rounds, THREADS) for t in vs)
        for k in range(rounds):
            acc = _merge(acc, tuple(t[:, k] for t in vs))
    if tail:
        acc = _merge(acc, _scalars(xs[:, head + nv * v:], tail))
    per_warp = _tree(tuple(t.view(b, WARPS, 32) for t in acc), 32)
    return _tree(per_warp, WARPS)


def model_partials(t: torch.Tensor, chunk: int = CHUNK):
    """(count, mean, M2) of each chunk of each plane of ``t``: (planes,
    chunks) float32 tensors, as the statistics kernel writes them."""
    v = 16 // t.element_size()
    planes, plane = t.shape[0] * t.shape[1], math.prod(t.shape[2:])
    x = t.float().reshape(-1)
    chunks = -(-plane // chunk)
    layouts = defaultdict(list)
    for p in range(planes):
        for c in range(chunks):
            g0, n = p * plane + c * chunk, min(chunk, plane - c * chunk)
            layouts[(n, *_span(g0, n, v))].append((p, c, g0))
    out = _empty(planes, chunks)
    for (n, head, nv, tail), members in layouts.items():
        idx = (torch.tensor([g0 for _, _, g0 in members])[:, None]
               + torch.arange(n))
        got = _chunk_stats(x[idx], head, nv, tail, v)
        ps = torch.tensor([p for p, _, _ in members])
        cs = torch.tensor([c for _, c, _ in members])
        for o, g in zip(out, got):
            o[ps, cs] = g
    return out


def model_coefficients(parts):
    """Each plane's mean and 1 / sqrt(var + eps) from its partials: lane l
    merges chunks l, l + 32, ... in order, then the shuffle tree."""
    planes, chunks = parts[0].shape
    rounds = -(-chunks // 32)
    pad = rounds * 32 - chunks
    lanes = tuple(F.pad(t, (0, pad)).view(planes, rounds, 32) for t in parts)
    acc = _empty(planes, 32)
    for k in range(rounds):
        acc = _merge(acc, tuple(t[:, k] for t in lanes))
    n, m, q = _tree(acc, 32)
    var = q / n
    return m, torch.ones_like(var) / torch.sqrt(
        var + torch.tensor(EPS, dtype=F32))


def model_apply(a, r=None, norm_r=False, weight=None, bias=None,
                slope=SLOPE):
    """N1's result: the float32 expression from the model's statistics
    (with the GroupNorm mode's per-channel affine where given), rounded to
    ``a``'s dtype once."""
    planes = a.shape[0] * a.shape[1]
    ma, ia = model_coefficients(model_partials(a))
    y = (a.float().reshape(planes, -1) - ma[:, None]) * ia[:, None]
    if weight is not None:
        y = (y * weight.float().repeat(a.shape[0])[:, None]
             + bias.float().repeat(a.shape[0])[:, None])
    if r is not None:
        rr = r.float().reshape(planes, -1)
        if norm_r:
            mb, ib = model_coefficients(model_partials(r))
            rr = (rr - mb[:, None]) * ib[:, None]
        y = y + rr
    y = torch.where(y > 0, y, y * torch.tensor(slope, dtype=F32))
    return y.to(a.dtype).reshape(a.shape)


# ------------------------------------------------------------------ helpers

def _inputs(shape, dtype, mode, seed=0):
    """Conv-output-like tensors: per-plane offsets and scales."""
    g = torch.Generator().manual_seed(seed)
    n, c = shape[:2]

    def one():
        off = torch.randn((n, c) + (1,) * (len(shape) - 2), generator=g)
        scale = torch.rand((n, c) + (1,) * (len(shape) - 2), generator=g)
        return (off + (0.2 + 3 * scale) * torch.randn(shape, generator=g)
                ).to(dtype)

    a = one()
    r = None if mode == "none" else one()
    return a, r, mode == "norm"


def _exact(a, r, norm_r):
    """float64 of the formula on the stored values, and the terms'
    magnitude |IN(a)| + |R| + 1."""
    def norm(t):
        t = t.double()
        dims = tuple(range(2, t.dim()))
        var, mean = torch.var_mean(t, dims, correction=0, keepdim=True)
        return (t - mean) / torch.sqrt(var + EPS)

    y = norm(a)
    rr = torch.zeros_like(y) if r is None else (
        norm(r) if norm_r else r.double())
    s = y + rr
    return torch.where(s > 0, s, s * SLOPE), 1 + y.abs() + rr.abs()


def _bf16_half_ulp(v):
    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 8)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _todays(a, r=None, norm_r=False):
    """The ResBlock's composition before N1, written out."""
    def inorm(t):
        return torch.instance_norm(t, None, None, None, None, True, 0.0,
                                   1e-5, torch.backends.cudnn.enabled)

    y = inorm(a)
    if r is not None:
        y = y + (inorm(r) if norm_r else r)
    return F.leaky_relu(y, 0.01)


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("plane", [1, 27, 385, 1728, 18513, 884736])
@pytest.mark.parametrize("v", [4, 8])
def test_chunks_cover_each_plane_once(plane, v):
    """Every voxel of every plane lies in exactly one chunk's head, vectors
    or tail, the vectors on the 16-byte grid; a 96^3 plane is 54 chunks."""
    for p in range(3):
        seen = []
        for c in range(-(-plane // CHUNK)):
            g0, n = p * plane + c * CHUNK, min(CHUNK, plane - c * CHUNK)
            head, nv, tail = _span(g0, n, v)
            assert head < v and tail < v and head + nv * v + tail == n
            assert nv == 0 or (g0 + head) % v == 0
            seen.append((g0, n))
        assert seen[0][0] == p * plane
        assert all(a + n == b for (a, n), (b, _) in zip(seen, seen[1:]))
        assert sum(n for _, n in seen) == plane
    assert -(-96 ** 3 // CHUNK) == 54


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_model_is_the_torch_composition(shape, dtype, mode):
    a, r, norm_r = _inputs(shape, dtype, mode)
    got = model_apply(a, r, norm_r)
    twin = instance_norm_lrelu_plain(a, r, norm_r)
    assert got.dtype == dtype and got.shape == a.shape
    exact, scale = _exact(a, r, norm_r)
    err = (got.double() - exact).abs()
    err_twin = (twin.double() - exact).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())
        torch.testing.assert_close(got, twin, rtol=1e-4, atol=1e-4)
    else:
        bound = _bf16_half_ulp(exact) + 1e-5 * scale
        assert bool((err <= bound).all()), float((err - bound).max())
        assert float(err.mean()) <= float(err_twin.mean())


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES[1:],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_mode_model_is_the_twin(shape, dtype):
    """MedNeXt's GroupNorm mode (a per-channel weight and bias, R = 0,
    slope 1): the model (the kernel's statistics, then ``IN(a) * g + b``
    rounded once) against the twin (``F.group_norm`` in float32, rounded
    once) and the float64 value, in units of 1 + |IN(a) g| + |b|."""
    a, _, _ = _inputs(shape, dtype, "none", seed=7)
    g = torch.Generator().manual_seed(8)
    weight = 1 + 0.5 * torch.randn(shape[1], generator=g)
    bias = 0.5 * torch.randn(shape[1], generator=g)
    got = model_apply(a, weight=weight, bias=bias, slope=1.0)
    twin = instance_norm_lrelu_plain(a, weight=weight, bias=bias, slope=1.0)
    norm, _ = _exact(a, None, False)
    norm = torch.where(norm > 0, norm, norm / SLOPE)     # undo the lrelu
    view = (1, -1) + (1,) * (a.dim() - 2)
    exact = norm * weight.double().view(view) + bias.double().view(view)
    scale = 1 + (norm * weight.double().view(view)).abs() \
        + bias.double().abs().view(view)
    err = (got.double() - exact).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())
        torch.testing.assert_close(got, twin, rtol=1e-4, atol=1e-4)
    else:
        bound = _bf16_half_ulp(exact) + 1e-5 * scale
        assert bool((err <= bound).all()), float((err - bound).max())
        assert float((got.float() - twin.float()).abs().max()) <= float(
            (2 * bound).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bf16"])
def test_model_gives_the_same_bits_twice(dtype):
    a, r, norm_r = _inputs((2, 3, 33, 33, 17), dtype, "norm", seed=4)
    first = model_apply(a, r, norm_r)
    assert torch.equal(_bits(first), _bits(model_apply(a, r, norm_r)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bf16"])
def test_cpu_route_is_todays_composition(dtype, mode):
    a, r, norm_r = _inputs((2, 3, 5, 7, 11), dtype, mode, seed=1)
    before = instance_norm_lrelu.launches
    got = instance_norm_lrelu(a, r, norm_r)
    assert torch.equal(_bits(got), _bits(_todays(a, r, norm_r)))
    assert instance_norm_lrelu.launches == before


@pytest.mark.parametrize("ci,co", [(16, 16), (32, 16), (1, 16)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bf16"])
def test_resblock_is_todays_composition(ci, co, dtype):
    """On the CPU the ResBlock gives today's bits: conv1, norm, lrelu;
    conv2, norm, + x or + IN(conv3(x)), lrelu; each 3x3x3 conv the float32
    conv of the operands rounded to x's dtype, rounded once, and conv3 the
    module's 1x1x1 conv in x's dtype."""
    torch.manual_seed(0)
    block = ResBlock(ci, co)
    x = torch.randn((2, ci, 6, 5, 7)).to(dtype)

    def conv(a, w):
        return F.conv3d(a.float(), w.to(dtype).float(), padding=1).to(dtype)

    with torch.no_grad():
        got = block(x)
        y = _todays(conv(x, block.conv1.weight))
        want = _todays(conv(y, block.conv2.weight),
                       x if ci == co else F.conv3d(
                           x, block.conv3.weight.to(dtype)), ci != co)
    assert torch.equal(_bits(got), _bits(want))


def test_every_resblock_takes_the_wrapper(monkeypatch):
    """Each of the ten ResBlocks calls the wrapper twice: after conv1 (no
    R), after conv2 with x (the four ci == co blocks) or with conv3's
    output normalized (enc0 and the five Ups)."""
    forms = []

    def counted(a, r=None, norm_r=False):
        forms.append("none" if r is None else "norm" if norm_r else "x")
        return instance_norm_lrelu(a, r, norm_r)

    monkeypatch.setattr(swin_unetr, "instance_norm_lrelu", counted)
    model = build_swin_unetr(SwinUNETRConfig(feature_size=16,
                                             num_heads=(1, 2, 4, 8),
                                             compute_dtype="float32"))
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32))
    assert sorted(forms) == sorted(["none"] * 10 + ["x"] * 4 + ["norm"] * 6)


@pytest.mark.parametrize("which", ["a", "r"])
def test_refuses_autograd(which):
    a, r, _ = _inputs((1, 2, 3, 4, 5), torch.float32, "x")
    (a if which == "a" else r).requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        instance_norm_lrelu(a, r)
    with torch.no_grad():
        instance_norm_lrelu(a, r)


@pytest.mark.parametrize("bad", ["shape", "dtype", "norm_r without r",
                                 "no planes"])
def test_refuses_what_it_cannot_compute(bad):
    a, r, _ = _inputs((1, 2, 3, 4, 5), torch.float32, "x")
    kw = {}
    if bad == "shape":
        r = r[:, :1]
    elif bad == "dtype":
        r = r.double()
    elif bad == "norm_r without r":
        r, kw = None, {"norm_r": True}
    else:
        a, r = a[0, 0, 0], None
    with pytest.raises(ValueError):
        instance_norm_lrelu(a, r, **kw)


def test_constants_are_the_modules():
    """The published eps and slope, and a chunk that is a whole number of
    16-byte vectors of either dtype."""
    assert (EPS, SLOPE) == (1e-5, 0.01)
    assert CHUNK % 8 == 0 and instnorm.MAX_PLANE == 2 ** 24
