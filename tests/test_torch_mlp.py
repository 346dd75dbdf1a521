"""MedNeXt's block MLP (``tpuseg_torch/ops/mlp.py``, E1): its twin against
the float64 composition at each of MedNeXt-L's 13 (ci, e, co), the twin's
two roundings, the CPU route, the refusals, the tiling plan, and a model of
``csrc/mlp.cu``'s packing, staging, chunks, output slices and ragged tiles
held to the twin. The kernel runs only on the card: ``chip_smoke.py``
phase 26 holds it to the twin there.

Tolerances. float32: 1e-5 of the output's scale: float32 sums of up to
4096 terms against float64. bf16 against float64 with the same two
roundings: one bf16 ulp of the output (the last rounding may fall either
way of a float32 sum) plus 2^-7 of the sum of |W3| |g| (an expanded value
whose float32 sum lies at a rounding edge may round either way: one ulp,
at most 2^-7 of it, for each value it sums) plus float32's slack.
"""

import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from tpuseg_torch.ops.mlp import (MAX_NCO, TILE, TILINGS, fused_mlp,
                                  fused_mlp_plain, mlp_plan)

ROOT = Path(__file__).resolve().parent.parent
#: MedNeXt-L's block MLPs: (name, ci, e, co)
SHAPES = (("level 0", 32, 96, 32), ("level 1", 64, 256, 64),
          ("level 2", 128, 1024, 128), ("level 3", 256, 2048, 256),
          ("level 4", 512, 4096, 512), ("down 0", 32, 128, 64),
          ("down 1", 64, 512, 128), ("down 2", 128, 1024, 256),
          ("down 3", 256, 2048, 512), ("up 3", 512, 4096, 256),
          ("up 2", 256, 2048, 128), ("up 1", 128, 512, 64),
          ("up 0", 64, 192, 32))
#: voxel blocks: odd and not a multiple of the 64-voxel tile
SIDES = ((3, 3, 3), (7, 7, 7), (127, 5, 3))


def _inputs(n, ci, e, co, side, seed=0, dtype=torch.float32,
            residual=True):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((n, ci, *side), generator=g).to(dtype)
    w2 = torch.randn((e, ci, 1, 1, 1), generator=g) / math.sqrt(ci)
    w3 = torch.randn((co, e, 1, 1, 1), generator=g) / math.sqrt(e)
    b2 = 0.1 * torch.randn((e,), generator=g)
    b3 = 0.1 * torch.randn((co,), generator=g)
    r = (torch.randn((n, co, *side), generator=g).to(dtype) if residual
         else None)
    return a, w2, b2, w3, b3, r


def _composition(a, w2, b2, w3, b3, r, round_to=None):
    """The block MLP in float64 on the operands rounded as the port rounds
    them: ``round_to`` None keeps everything exact (the float32 twin);
    bf16 rounds the weights, the expanded value and nothing else (the
    output's rounding is the caller's); returns the sum and the sum of
    |W3| |g| over each output's terms."""
    n, ci = a.shape[:2]
    e, co = w2.shape[0], w3.shape[0]
    cast = (lambda t: t) if round_to is None else (
        lambda t: t.to(round_to).double())
    w2d = cast(w2.double()).reshape(e, ci)
    w3d = cast(w3.double()).reshape(co, e)
    h = torch.matmul(w2d, a.double().reshape(n, ci, -1)) + b2.double().view(
        1, -1, 1)
    gv = cast(F.gelu(h))
    y = torch.matmul(w3d, gv) + b3.double().view(1, -1, 1)
    if r is not None:
        y = y + r.double().reshape(n, co, -1)
    mag = torch.matmul(w3d.abs(), gv.abs())
    shape = (n, co, *a.shape[2:])
    return y.view(shape), mag.view(shape)


def _assert_within_bf16_bound(got, exact, mag, b3):
    """|got - exact| within one bf16 ulp of exact, 2^-7 of the |W3| |g|
    sum and float32's slack (module docstring)."""
    e = torch.floor(torch.log2(exact.abs().clamp(min=2.0 ** -126)))
    slack = 2.0 ** -16 * (mag + b3.double().abs().view(1, -1, 1, 1, 1))
    over = (got.double() - exact).abs() - (torch.exp2(e - 7) + 2.0 ** -7
                                           * mag + slack)
    assert float(over.max()) <= 0


@pytest.mark.parametrize("name,ci,e,co", SHAPES, ids=[s[0] for s in SHAPES])
def test_twin_is_the_float64_composition(name, ci, e, co):
    """float32: conv2, its bias, erf GELU, conv3, its bias and the
    residual, no rounding, within float32's slack of float64; at the
    net's 13 shapes, each on one of three ragged voxel blocks."""
    side = SIDES[[s[0] for s in SHAPES].index(name) % len(SIDES)]
    args = _inputs(2 if ci < 256 else 1, ci, e, co, side, seed=ci + e)
    got = fused_mlp_plain(*args)
    want, _ = _composition(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "no residual"])
def test_bf16_twin_rounds_exactly_twice(residual):
    """bf16: the twin equals the float32 pipeline that rounds the expanded
    value and the output and nothing else, lies within the bound of the
    float64 value with those two roundings, and differs both from the
    pipeline that leaves the expanded value unrounded and from one that
    also rounds the pre-activation."""
    a, w2, b2, w3, b3, r = _inputs(2, 64, 256, 64, (7, 7, 9), seed=4,
                                   dtype=torch.bfloat16, residual=residual)
    got = fused_mlp_plain(a, w2, b2, w3, b3, r)
    assert got.dtype == torch.bfloat16
    w2f = w2.bfloat16().float().reshape(256, 64)
    w3f = w3.bfloat16().float().reshape(64, 256)
    h = torch.matmul(w2f, a.float().reshape(2, 64, -1)) + b2.view(1, -1, 1)

    def finish(gv):
        y = torch.matmul(w3f, gv) + b3.view(1, -1, 1)
        if r is not None:
            y = y + r.float().reshape(2, 64, -1)
        return y.bfloat16().view(got.shape)

    assert torch.equal(got, finish(F.gelu(h).bfloat16().float()))
    assert not torch.equal(got, finish(F.gelu(h)))
    assert not torch.equal(got, finish(F.gelu(h.bfloat16().float())
                                       .bfloat16().float()))
    exact, mag = _composition(a, w2, b2, w3, b3, r, round_to=torch.bfloat16)
    _assert_within_bf16_bound(got, exact, mag, b3)


def test_a_cpu_tensor_takes_the_twin():
    args = _inputs(2, 32, 96, 32, (5, 6, 7), dtype=torch.bfloat16)
    before = fused_mlp.launches
    assert torch.equal(fused_mlp(*args), fused_mlp_plain(*args))
    assert fused_mlp.launches == before


@pytest.mark.parametrize("bad", [
    "float32 on the card", "not contiguous", "residual not contiguous",
    "weight shape", "bias shape", "residual shape", "residual dtype",
    "not 5-d", "bf16 weight", "untiled width"])
def test_fused_mlp_refuses_what_it_cannot_compute(bad):
    """Refused before anything launches; the meta device stands in for the
    card (it is not the CPU, so it takes the kernel's route)."""
    ci, e, co = 32, 96, 32
    if bad == "untiled width":
        ci, e, co = 48, 96, 48
    a, w2, b2, w3, b3, r = (t.to("meta") for t in _inputs(
        2, ci, e, co, (4, 5, 6), dtype=torch.bfloat16))
    if bad == "float32 on the card":
        a, r = a.float(), r.float()
    elif bad == "not contiguous":
        a = a.transpose(3, 4)
        r = r.transpose(3, 4)
    elif bad == "residual not contiguous":
        r = r.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "weight shape":
        w2 = w2[:, :16]
    elif bad == "bias shape":
        b3 = b3[:16]
    elif bad == "residual shape":
        r = r[:, :16]
    elif bad == "residual dtype":
        r = r.float()
    elif bad == "bf16 weight":
        w3 = w3.bfloat16()
    elif bad == "not 5-d":
        a = a[0]
    with pytest.raises(ValueError):
        fused_mlp(a, w2, b2, w3, b3, r)


@pytest.mark.parametrize("which", ["a", "w2", "b3", "r"])
def test_fused_mlp_refuses_autograd(which):
    args = list(_inputs(1, 32, 96, 32, (3, 3, 3)))
    args["a w2 b2 w3 b3 r".split().index(which)].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        fused_mlp(*args)
    with torch.no_grad():
        fused_mlp(*args)


@pytest.mark.parametrize("name,ci,e,co", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_shape_of_the_net_has_a_tiling(name, ci, e, co):
    """Each of MedNeXt-L's 13 MLPs: output slices of at most 256, the
    chunk of its tiling dividing e, the weights kept where e is one or two
    chunks of one slice."""
    plan = mlp_plan(ci, e, co)
    assert plan.nco == min(co, MAX_NCO) and plan.slices * plan.nco == co
    assert plan.ec == TILINGS[(ci, plan.nco)]
    assert plan.chunks * plan.ec == e
    assert plan.resident == (plan.chunks <= 2 and plan.slices == 1)
    assert plan.resident == (name in ("level 0", "down 0", "up 0"))


@pytest.mark.parametrize("ci,e,co", [(48, 96, 48), (32, 80, 32),
                                     (32, 96, 40)])
def test_plan_refuses_shapes_without_a_tiling(ci, e, co):
    with pytest.raises(ValueError, match="MedNeXt-L's shapes"):
        mlp_plan(ci, e, co)


# ---- a model of csrc/mlp.cu: packing, staging, chunks, slices, tiles ------

def _pack(w2, w3, ec, nco):
    """``fused_mlp_pack_kernel``: 16-byte words (8 bf16) of W2 as [e / ec]
    [ci / 8][ec][8], then W3 as [co / nco][e / ec][ec / 8][nco][8]."""
    e, ci = w2.shape[:2]
    co = w3.shape[0]
    w2b = w2.reshape(e, ci).bfloat16()
    w3b = w3.reshape(co, e).bfloat16()
    chunks = e // ec
    words = []
    for i in range(e * ci // 8):
        j, rem = divmod(i, ec * ci // 8)
        kg, n = divmod(rem, ec)
        words.append(w2b[j * ec + n, 8 * kg:8 * kg + 8])
    for i in range(co * e // 8):
        blk, rem = divmod(i, nco * ec // 8)
        s, j = divmod(blk, chunks)
        kg, o = divmod(rem, nco)
        words.append(w3b[s * nco + o, j * ec + 8 * kg:j * ec + 8 * kg + 8])
    return torch.stack(words)


def model_fused_mlp(a, w2, b2, w3, b3, r, ec, nco):
    """E1 as ``fused_mlp_kernel`` computes it: units of one 64-voxel tile
    of a sample and one slice of nco outputs (tile fastest, then sample,
    then slice); X staged MN-major (word (kb * 8 + mb) * 8 + k8 holds 8
    voxels of channel 8 kb + k8, zero past the sample's last voxel) and
    read back as wgmma's transposed A; per chunk the stage's W2c [ci / 8]
    [ec][8] and W3c [ec / 8][nco][8] words from the packed weights; h =
    X W2c^T + b2, GELU rounded to bf16, y += g W3c^T; the epilogue's b3 and
    R, one rounding, rows stored up to the tile's last voxel. float64
    sums, so the layouts and not the rounding are what is held."""
    n, ci = a.shape[:2]
    e, co = w2.shape[0], w3.shape[0]
    vox = math.prod(a.shape[2:])
    words = _pack(w2, w3, ec, nco).double()
    chunks, slices = e // ec, co // nco
    tiles = -(-vox // TILE)
    x = a.double().reshape(n, ci, vox)
    res = None if r is None else r.double().reshape(n, co, vox)
    out = torch.full((n, co, vox), float("nan"), dtype=torch.float64)
    m = torch.arange(TILE)
    k = torch.arange(ci)
    for u in range(n * tiles * slices):
        cs, rest = divmod(u, n * tiles)
        s_n, t = divmod(rest, tiles)
        m0 = t * TILE
        rows = min(TILE, vox - m0)
        xs = torch.zeros((ci * 8, 8), dtype=torch.float64)
        for w in range(ci * 8):
            ch, mb = (w & 7) + 8 * (w >> 6), (w >> 3) & 7
            for j in range(8):
                if 8 * mb + j < rows:
                    xs[w, j] = x[s_n, ch, m0 + 8 * mb + j]
        xa = xs[(((k // 8) * 8).view(1, -1) + (m // 8).view(-1, 1)) * 8
                + (k % 8).view(1, -1), (m % 8).view(-1, 1)]
        y = torch.zeros((TILE, nco), dtype=torch.float64)
        for c in range(chunks):
            w2c = words[c * ec * ci // 8:(c + 1) * ec * ci // 8]
            base = e * ci // 8 + (cs * chunks + c) * nco * ec // 8
            w3c = words[base:base + nco * ec // 8]
            kk = torch.arange(ci)
            b2m = w2c[(kk // 8).view(1, -1) * ec + torch.arange(ec).view(
                -1, 1), (kk % 8).view(1, -1)]
            jj = torch.arange(ec)
            b3m = w3c[(jj // 8).view(1, -1) * nco + torch.arange(nco).view(
                -1, 1), (jj % 8).view(1, -1)]
            h = xa @ b2m.T + b2[c * ec:(c + 1) * ec].double()
            gv = F.gelu(h).to(torch.bfloat16).double()
            y = y + gv @ b3m.T
        v = y + b3[cs * nco:(cs + 1) * nco].double()
        if res is not None:
            staged = torch.zeros((TILE, nco), dtype=torch.float64)
            staged[:rows] = res[s_n, cs * nco:(cs + 1) * nco, m0:m0 + rows].T
            v = v + staged
        keep = slice(m0, m0 + rows)
        assert torch.isnan(out[s_n, cs * nco:(cs + 1) * nco, keep]).all(), \
            "an output written twice"
        out[s_n, cs * nco:(cs + 1) * nco, keep] = v[:rows].T
    assert not torch.isnan(out).any(), "an output never written"
    return out.to(torch.bfloat16).view(n, co, *a.shape[2:])


@pytest.mark.parametrize("n,ci,e,co,nco,ec,side,residual", [
    (2, 32, 96, 32, 32, 96, (5, 7, 9), True),      # one chunk, ragged tiles
    (1, 64, 192, 32, 32, 96, (4, 4, 8), True),     # two chunks, whole tiles
    (2, 32, 128, 64, 32, 32, (3, 5, 11), True),    # two slices, four chunks
    (1, 16, 64, 48, 16, 16, (2, 3, 11), False),    # three slices, no R
], ids=["one chunk", "two chunks", "two slices", "three slices"])
def test_kernel_model_is_the_twin(n, ci, e, co, nco, ec, side, residual):
    """The model (float64 sums, the kernel's two roundings) against the
    bf16 twin within the bound of the module docstring: one chunk and
    several in order, output slices, tails of tiles and samples, with and
    without a residual."""
    args = _inputs(n, ci, e, co, side, seed=11, dtype=torch.bfloat16,
                   residual=residual)
    got = model_fused_mlp(*args, ec, nco)
    twin = fused_mlp_plain(*args)
    exact, mag = _composition(*args, round_to=torch.bfloat16)
    _assert_within_bf16_bound(got, exact, mag, args[4])
    _assert_within_bf16_bound(twin, exact, mag, args[4])
    assert float((got.float() != twin.float()).float().mean()) < 0.01


def test_kernel_source_holds_the_tilings():
    """Every tiling of ``TILINGS`` is built, and the constants the model
    and the plan share with the source: change them with ``csrc/mlp.cu``."""
    src = (ROOT / "tpuseg_torch" / "csrc" / "mlp.cu").read_text()
    for (ci, nco), ec in TILINGS.items():
        assert f"TPUSEG_MLP_TILING({ci}, {nco}, {ec})" in src, (ci, nco, ec)
    assert src.count("  TPUSEG_MLP_TILING(") == len(TILINGS)
    for const in (f"constexpr int kTile = {TILE};",
                  f"constexpr int kMaxNco = {MAX_NCO};",
                  "resident = chunks <= kStages && slices == 1;",
                  "constexpr int kStages = 2;",
                  "const int k = (w & 7) + 8 * (w >> 6), mb = (w >> 3) & 7;",
                  "g.cs = u / per_slice;"):
        assert const in src, const
