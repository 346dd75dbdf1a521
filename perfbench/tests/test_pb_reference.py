"""The plain reference against the program's plain twins and its U-Net,
at small sizes on the CPU. Only these tests import both: the reference
itself imports nothing of the program."""

import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import cells, infer_cell, train_cell
from perfbench.reference import post, train, unet
from perfbench.tests.tiny import tiny_cell

MODEL = {"in_channels": 1, "features": [32, 64, 128, 256],
         "head_features": 32}


def _program_unet(state):
    from tpuseg_torch.core import ModelConfig
    from tpuseg_torch.models import UNet3D

    model = UNet3D(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(state)
    return model


def _state(seed=1):
    state = cells.load_arch("unet3d").init_state(MODEL, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for k, v in state.items():      # statistics and affines off (0, 1)
        if v.dim() == 1:
            state[k] = v + 0.1 * torch.rand(v.shape, generator=g)
    return state


def test_unet_eval_matches_the_program():
    state = _state()
    x = torch.rand(2, 16, 16, 24, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = _program_unet(state).eval()(x)
        got = unet.forward(state, x)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


def test_unet_train_matches_the_program():
    state = _state(2)
    model = _program_unet(state).train()
    x = torch.rand(2, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    params = {k: v.clone().requires_grad_("running" not in k)
              for k, v in state.items()}
    stats = {k: v for k, v in params.items() if "running" in k}
    got = unet.forward(params, x, train=True, stats=stats)
    want = model(x)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
    for k, v in model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(stats[k], v, rtol=1e-5, atol=1e-6)
    # a weighted sum: a plain sum's gradient cancels under BatchNorm
    r = torch.rand(x.shape, generator=torch.Generator().manual_seed(2))
    for out in (got, want):
        ((out["fg_logits"] - out["peak_logits"]) * r).sum().backward()
    # float32 BatchNorm backward over 16-voxel bottleneck statistics
    # amplifies round-off: gradients agree to ~0.5% a leaf, not elementwise
    for k, p in model.named_parameters():
        err = (params[k].grad - p.grad).norm() / p.grad.norm()
        assert err < 2e-2, (k, float(err))


def _maps(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((1, 1) + shape, generator=g)
    for _ in range(3):
        x = F.avg_pool3d(x, 3, stride=1, padding=1, count_include_pad=False)
    x = (x - x.min()) / (x.max() - x.min())
    return x[0, 0].bfloat16(), torch.sigmoid(20 * (x[0, 0] - 0.6)).bfloat16()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_post_matches_the_programs_twins(seed):
    from tpuseg_torch.ops.calibrate import threshold_for_fraction
    from tpuseg_torch.ops.filter import size_filter_and_compact
    from tpuseg_torch.ops.watershed import watershed

    fg, pk = _maps((12, 40, 36), seed)
    thr = threshold_for_fraction(fg, 0.3, sample_stride=4)
    assert torch.equal(thr, post.threshold_for_fraction(fg, 0.3, 4))
    want = size_filter_and_compact(
        watershed(fg, pk, peak_threshold=0.35, fg_threshold=thr,
                  peak_radius=(1, 2, 2), flood_iters=96, plain=True), 27,
        plain=True)
    got = post.size_filter_and_compact(
        post.watershed(fg, pk, 0.35, thr, (1, 2, 2), 96), 27)
    assert int(want.max()) > 1
    assert torch.equal(got, want)


def test_flood_cap_matches():
    from tpuseg_torch.ops.watershed import watershed

    fg, pk = _maps((8, 32, 32), 5)
    want = watershed(fg, pk, peak_threshold=0.9, fg_threshold=0.05,
                     peak_radius=2, flood_iters=5, plain=True)
    got = post.watershed(fg, pk, 0.9, 0.05, (2, 2, 2), 5)
    assert torch.equal(got, want)


def test_percentiles_and_calibration_match():
    from tpuseg_torch.data.normalize import histogram_percentile_scalars
    from tpuseg_torch.ops.calibrate import (adaptive_upper_pct,
                                            expected_fg_fraction,
                                            nms_radius_from_half_sizes)

    g = torch.Generator().manual_seed(3)
    vol = torch.rand(16, 32, 48, generator=g) ** 3
    want = histogram_percentile_scalars(vol, (1.0, 99.8), sample_stride=4)
    got = post.percentile_scalars(vol, (1.0, 99.8), 4)
    assert [float(v) for v in want] == [float(v) for v in got]
    halfs = np.random.default_rng(0).uniform(2, 9, (50, 3)) * [0.6, 1, 1]
    cal = post.calibration(halfs, 10 ** 6, 99.8)
    frac = expected_fg_fraction(halfs, 10 ** 6)
    assert cal["fraction"] == frac
    assert cal["upper"] == adaptive_upper_pct(frac, default_upper=99.8)
    assert cal["radius"] == nms_radius_from_half_sizes(halfs)


def test_prepared_batch_and_losses_match():
    from tpuseg_torch.core import Config
    from tpuseg_torch.losses import total_loss
    from tpuseg_torch.train.step import prepare_batch

    cell = tiny_cell("train-b8-p64")
    data = {**cell.config["settings"]}
    cfg = Config().override(**{k: v for k, v in data.items()
                               if k.startswith(("data.", "train."))})
    rng = np.random.default_rng(0)
    raw = {"image": rng.random((2, 8, 16, 16), dtype=np.float32),
           "centers": rng.uniform(0, 8, (2, 64, 3)).astype(np.float32),
           "half_sizes": rng.uniform(1, 4, (2, 64, 3)).astype(np.float32),
           "valid": np.arange(64)[None].repeat(2, 0) < [[5], [3]]}
    imgs, tgt = prepare_batch({k: torch.from_numpy(v) for k, v in
                               raw.items()}, cfg, seed=9, step=4)
    s = {"data": {k.split(".", 1)[1]: v for k, v in data.items()
                  if k.startswith("data.")}}
    r_imgs, r_tgt = train.prepare_batch(raw, s["data"], 9, 4, "cpu")
    torch.testing.assert_close(r_imgs, imgs, rtol=0, atol=1e-6)
    for k in tgt:
        torch.testing.assert_close(r_tgt[k], tgt[k], rtol=0, atol=1e-6)
    out = {"fg_logits": torch.randn(imgs.shape), "peak_logits":
           torch.randn(imgs.shape)}
    want = total_loss(out, tgt, cfg.train)[1]
    got = train.losses(out, r_tgt, 0.5)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["infer-stack600", "infer-touch400",
                                  "train-b8-p64"])
def test_a_float32_program_meets_the_reference(name):
    """With the configuration computing in float32, the whole check reads
    round-off: the reference and the program compute one function."""
    cell = tiny_cell(name)
    cell.config["model"]["compute_dtype"] = "float32"
    if "infer.compute_dtype" in cell.config["settings"]:
        cell.config["settings"]["infer.compute_dtype"] = "float32"
    driver = infer_cell if cell.config["kind"] == "infer" else train_cell
    res = driver.run(cell, 77, 0.2, False, time.perf_counter(), device="cpu")
    got = {k: v for k, v, _ in res.checks}
    if name.startswith("infer"):
        assert got["pct_gap"] == got["label_mismatch"] == 0
        assert got["prob_gap_max"] < 1e-5
    else:
        assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-3
        assert got["bn_stats_gap"] < 1e-3
