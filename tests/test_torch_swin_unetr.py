"""SwinUNETR (``tpuseg_torch/models/swin_unetr.py``) and its shifted-window
attention (``tpuseg_torch/ops/window_attn.py``) against the plain float32
reference (the benchmark's ``perfbench/reference/swin_unetr.py``) on
seeded random weights, at feature 16 with heads 1/2/4/8 (head dim 16, as published) and
blocks of 32^3 and 32 x 64 x 64: token grids of 16^3 (padded to 21^3), 8^3
(14^3), 4^3 and 2^3 (shrunk windows) and 16 x 32 x 32 down to 2 x 4 x 4
(anisotropic windows and shifts), every shift mask and merging. The W1
kernel runs only on the card: ``chip_smoke.py`` phase 23 holds it to the
twin there.

Tolerances. float32: rtol 1e-4, atol 1e-4 of logits up to ~6: the port
sums in other orders than the reference (the twin's exp / sum against
``torch.softmax``, the transposed conv as a channel product against
``conv_transpose3d``, ``torch.instance_norm`` against ``var_mean``), each
a few float32 ulps, over ~40 layers (measured 1.8e-5). bf16 against the
float32 reference: mean absolute error under 0.04 and worst under 0.4:
every op rounds to 8 significant bits (2^-9 relative), InstanceNorm and
LayerNorm rescale the errors back to the activations' size at each of ~40
layers (measured 0.016 and 0.15).
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

from tpuseg_torch.core import Config, InferConfig, PostprocConfig
from tpuseg_torch.data import synthesize_volume
from tpuseg_torch.infer import make_infer_fn
from tpuseg_torch.infer.pipeline import make_infer_stages
from tpuseg_torch.models import SwinUNETR, SwinUNETRConfig, build_swin_unetr
from tpuseg_torch.models.swin_unetr import window_and_shift
from tpuseg_torch.ops import window_attn
from tpuseg_torch.ops.window_attn import (window_attention,
                                          window_attention_plain)
from tpuseg_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"in_channels": 1, "out_channels": 2, "feature_size": 16,
         "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8],
         "window_size": 7, "patch_size": 2, "mlp_ratio": 4.0,
         "compute_dtype": "float32", "param_dtype": "float32"}
PUBLISHED = dict(SMALL, feature_size=48, num_heads=[3, 6, 12, 24])
BLOCKS = [(1, 32, 32, 32), (2, 32, 64, 64)]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_PATH = ROOT / "perfbench" / "reference" / "swin_unetr.py"
REF = _load(REF_PATH, "swin_unetr_reference")
#: the ``model`` keys the program's config takes; window 7, patch 2 and
#: float32 parameters are its constants
FIELDS = {f.name for f in dataclasses.fields(SwinUNETRConfig)}


def _config(model: dict, **kw) -> SwinUNETRConfig:
    return SwinUNETRConfig(**{k: v for k, v in dict(model, **kw).items()
                              if k in FIELDS})


def _arch():
    """The benchmark's architecture file (``perfbench/arch/swin_unetr.py``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import cells

    return cells.load_arch("swin_unetr")


def _model(dtype="float32", seed=3):
    """Seeded weights with biases, norms and tables moved off their
    initial values, so that each of them counts."""
    model = build_swin_unetr(_config(SMALL, compute_dtype=dtype), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias_table"):
                p.copy_(torch.randn(p.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def float32_model():
    return _model()


@pytest.mark.parametrize("shape", BLOCKS, ids=lambda s: "x".join(map(str, s)))
def test_float32_port_is_the_reference(shape, float32_model):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(7))
    p = dict(float32_model.state_dict())
    with torch.no_grad():
        got = float32_model(x)
        want = REF.forward(p, x, SMALL)
    for k in ("fg_logits", "peak_logits"):
        assert got[k].dtype == torch.float32 and got[k].shape == shape
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


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
        assert float(gap.mean()) < 0.04 and float(gap.max()) < 0.4, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_always_takes_the_kernels_wrapper(dtype, monkeypatch):
    """Every Swin block calls ``window_attention`` whatever the dtype (two
    a stage): on the CPU the wrapper runs the twin, on the card the kernel,
    which refuses float32 rather than give way to the twin there."""
    from tpuseg_torch.models import swin_unetr

    calls = []

    def counted(*args):
        calls.append(args[0].dtype)
        return window_attention(*args)

    monkeypatch.setattr(swin_unetr, "window_attention", counted)
    with torch.no_grad():
        _model(dtype)(torch.zeros(1, 32, 32, 32))
    assert calls == [getattr(torch, dtype)] * 8


def test_block_sides_must_be_multiples_of_32(float32_model):
    with pytest.raises(ValueError, match="multiples of 32"):
        float32_model(torch.zeros(1, 32, 48, 32))


@pytest.mark.parametrize("grid,shifted,want", [
    ((48, 48, 48), True, ((7, 7, 7), (3, 3, 3))),
    ((48, 48, 48), False, ((7, 7, 7), (0, 0, 0))),
    ((6, 6, 6), True, ((6, 6, 6), (0, 0, 0))),
    ((4, 8, 8), True, ((4, 7, 7), (0, 3, 3))),
    ((7, 8, 2), True, ((7, 7, 2), (0, 3, 0)))])
def test_windows_shrink_to_small_sides(grid, shifted, want):
    assert window_and_shift(grid, 7, shifted) == want


def _direct_attention(qkv, table, window, shift, windows):
    """The attention of each window and head one at a time, its bias and
    mask from the tokens' coordinates, as Swin writes them: the relative
    position's row of the table and, with a shift, -100 between tokens of
    different regions of the rolled grid (MONAI's ``compute_mask`` slices
    along each axis)."""
    bw, n, _, heads, hd = qkv.shape
    q, k, v = qkv.double().unbind(2)
    coords = torch.tensor([(z, y, x) for z in range(window[0])
                           for y in range(window[1])
                           for x in range(window[2])])
    rel = coords[:, None] - coords[None, :] + 6
    bias = table.double()[(rel[..., 0] * 13 + rel[..., 1]) * 13
                          + rel[..., 2]]                   # (N, N, heads)

    def axis_region(pos, length, w, s):
        ids = torch.zeros(length, dtype=torch.long)
        for r, sl in enumerate((slice(-w), slice(-w, -s), slice(-s, None))):
            ids[sl] = r
        return ids[pos]

    nw = windows[0] * windows[1] * windows[2]
    out = torch.empty(bw, n, heads * hd, dtype=torch.float64)
    for b in range(bw):
        wz, rest = divmod(b % nw, windows[1] * windows[2])
        wy, wx = divmod(rest, windows[2])
        origin = torch.tensor([wz * window[0], wy * window[1],
                               wx * window[2]])
        pos = origin + coords
        region = torch.zeros(n, dtype=torch.long)
        if any(shift):
            for a in range(3):
                region = region * 3 + axis_region(
                    pos[:, a], windows[a] * window[a], window[a], shift[a])
        mask = (region[:, None] != region[None, :]).double() * -100.0
        for h in range(heads):
            s = q[b, :, h] @ k[b, :, h].T * hd ** -0.5 + bias[..., h] + mask
            out[b, :, h * hd:(h + 1) * hd] = torch.softmax(s, -1) @ v[b, :, h]
    return out


ATTN_CASES = [((1, 1, 1), (7, 7, 7), (0, 0, 0), 2),
              ((2, 2, 2), (7, 7, 7), (3, 3, 3), 1),
              ((3, 3, 3), (7, 7, 7), (0, 0, 0), 1),   # a 16^3 grid padded
              ((1, 2, 2), (4, 7, 7), (0, 3, 3), 2),   # shrunk along z
              ((1, 1, 1), (2, 4, 4), (0, 0, 0), 3),   # shrunk on every axis
              ((2, 1, 3), (5, 3, 7), (2, 1, 3), 1)]


def _qkv(windows, window, heads, blocks, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = window[0] * window[1] * window[2]
    bw = blocks * windows[0] * windows[1] * windows[2]
    qkv = torch.randn((bw, n, 3, heads, 16), generator=g).to(dtype)
    return qkv, torch.randn((13 ** 3, heads), generator=g)


@pytest.mark.parametrize("windows,window,shift,blocks", ATTN_CASES)
def test_twin_is_the_direct_attention(windows, window, shift, blocks):
    """float32: the materialised softmax in another form, float32 ulps;
    bf16 qkv: P rounded to bf16 (2^-9 relative) and the output to bf16,
    within 2^-6 of values up to ~3."""
    qkv, table = _qkv(windows, window, 2, blocks, torch.float32)
    want = _direct_attention(qkv, table, window, shift, windows)
    got = window_attention_plain(qkv, table, window, shift, windows)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    q16 = qkv.bfloat16()
    got16 = window_attention_plain(q16, table, window, shift, windows)
    assert got16.dtype == torch.bfloat16
    want16 = _direct_attention(q16, table, window, shift, windows)
    assert float((got16.double() - want16).abs().max()) < 2.0 ** -6


@pytest.mark.parametrize("windows,window,shift,blocks", ATTN_CASES[:2])
def test_a_cpu_tensor_takes_the_twin(windows, window, shift, blocks):
    qkv, table = _qkv(windows, window, 3, blocks, torch.bfloat16, seed=1)
    before = window_attention.launches
    assert torch.equal(window_attention(qkv, table, window, shift, windows),
                       window_attention_plain(qkv, table, window, shift,
                                              windows))
    assert window_attention.launches == before


@pytest.mark.parametrize("bad", ["not whole windows", "table heads",
                                 "shift", "not qkv"])
def test_window_attention_refuses_what_it_cannot_compute(bad):
    qkv, table = _qkv((2, 2, 2), (7, 7, 7), 2, 1, torch.float32)
    window, shift, windows = (7, 7, 7), (3, 3, 3), (2, 2, 2)
    if bad == "not whole windows":
        windows = (3, 2, 2)
    elif bad == "table heads":
        table = table[:, :1]
    elif bad == "shift":
        shift = (7, 0, 0)
    else:
        qkv = qkv[:, :, 0]
    with pytest.raises(ValueError):
        window_attention(qkv, table, window, shift, windows)


def test_index_and_regions_are_built_once_a_geometry():
    a = window_attn.relative_index((2, 4, 4), 13, torch.device("cpu"))
    assert a is window_attn.relative_index((2, 4, 4), 13, torch.device("cpu"))
    assert a.shape == (32, 32) and int(a[0, 0]) == 1098
    r = window_attn.region_ids((2, 2, 2), (7, 7, 7), (3, 3, 3),
                               torch.device("cpu"))
    assert r.shape == (8, 343)
    # the last window holds the last 7 positions of each axis: the rolled
    # grid's regions 1 (w - s of them) and 2 (s)
    assert int(r[0].max()) == 0 and sorted(set(r[7].tolist())) == sorted(
        (a * 3 + b) * 3 + c for a in (1, 2) for b in (1, 2) for c in (1, 2))


def test_state_is_the_architecture_files():
    """Names and shapes equal ``perfbench/arch/swin_unetr.state_shapes``,
    and the published net has 62,186,708 parameters (MONAI's count of its
    SwinUNETR at feature 48, in 1, out 2; the relative-position index is
    built, not a parameter)."""
    arch = _arch()
    for model in (SMALL, PUBLISHED):
        with torch.device("meta"):
            net = SwinUNETR(_config(model))
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert shapes == arch.state_shapes(model)
        assert list(shapes) == list(arch.state_shapes(model))
    assert sum(math.prod(s) for s in shapes.values()) == 62_186_708
    assert sum(p.numel() for p in net.parameters()) == 62_186_708


def _infer_cfg():
    return Config(
        infer=InferConfig(tile=(32, 32, 32), halo=0, tile_batch=2,
                          compute_dtype="float32"),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16))


def test_infer_fn_gives_the_eager_stages_labels(float32_model):
    """The normal path, on the CPU eager on every call, with no warning
    about a receptive field (the net has no U-Net ``features``), equals
    its own two stages; the sweep's net calls mark the model's stages."""
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
    per_batch = ["net", "swin.transformer", "swin.cnn", "tile_glue"]
    assert names == (["norm", "tile_glue"] + per_batch * 2
                     + ["watershed", "filter"])


def test_reference_imports_only_torch():
    tree = ast.parse(REF_PATH.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "itertools", "torch"}
