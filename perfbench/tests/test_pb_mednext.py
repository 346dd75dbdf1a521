"""MedNeXt behind the architecture seam (``arch/mednext.py``): its seeded
state, its reference forward against the program's module, its FLOPs
against torch's count, D1's work against a direct count, its cell loaded
with no file edited, its readers, and a tiny inference cell of it run end
to end on the CPU."""

import copy
import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import cells, infer_cell, program, work
from perfbench.tests.test_pb_files import _check_cell

SMALL = {"in_channels": 1, "out_channels": 2, "n_channels": 4,
         "exp_r": [3, 4, 8, 8, 8, 8, 8, 4, 3], "block_counts": [1] * 9,
         "kernel_size": 5, "compute_dtype": "float32",
         "param_dtype": "float32"}
CELL = "infer-mednext-stack600"


def _arch():
    return cells.load_arch("mednext")


def test_init_state_is_deterministic_by_seed():
    arch = _arch()
    a, b = arch.init_state(SMALL, 7, "cpu"), arch.init_state(SMALL, 7, "cpu")
    c = arch.init_state(SMALL, 8, "cpu")
    assert list(a) == list(arch.state_shapes(SMALL))
    assert all(tuple(v.shape) == arch.state_shapes(SMALL)[k]
               for k, v in a.items())
    assert all(torch.equal(a[k], b[k]) for k in a)
    drawn = [k for k, v in a.items() if v.dim() > 1]
    assert all(not torch.equal(a[k], c[k]) for k in drawn)
    assert not any(arch.is_statistic(k) for k in a)
    # kernels at std 1 / sqrt(fan in): a depthwise kernel's 125 taps, a
    # transposed 1x1x1 conv's input channels
    assert arch._fan_in("enc.0.0.conv1.weight", (4, 1, 5, 5, 5)) == 125
    assert arch._fan_in("up.1.res_conv.weight", (16, 8, 1, 1, 1)) == 16
    assert arch._fan_in("head.weight", (4, 2, 1, 1, 1)) == 4


@pytest.mark.parametrize("shape", [(1, 32, 32, 32), (1, 16, 32, 48)])
def test_forward_is_the_programs_module(shape):
    """float32 on the CPU: the reference against the module the program
    builds (``build``) from the same state; sums in other orders, 1e-4 of
    the logits' scale (``tests/test_torch_mednext.py`` says why)."""
    arch = _arch()
    state = arch.init_state(SMALL, 3, "cpu")
    g = torch.Generator().manual_seed(4)
    for k, v in state.items():          # biases and affines off (0, 1)
        if v.dim() == 1:
            state[k] = v + 0.1 * torch.randn(v.shape, generator=g)
    model = arch.build(None, SMALL, "cpu")
    model.load_state_dict(state)
    model.eval()
    x = torch.rand(shape, generator=g)
    with torch.no_grad():
        got = model(x)
        want = arch.forward(state, x, SMALL)
    for k in ("fg_logits", "peak_logits"):
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= 1e-4 * scale


def test_build_refuses_what_the_program_fixes():
    """float32 parameters are the program's constant: a configuration
    that states another dtype is refused, not built as if it had not."""
    with pytest.raises(ValueError, match="param_dtype"):
        _arch().build(None, dict(SMALL, param_dtype="bfloat16"), "cpu")


@pytest.mark.parametrize("block", [(32, 32, 32), (16, 32, 48)])
def test_flops_are_torchs_count(block):
    """``flops`` against ``FlopCounterMode`` on the program's module (the
    float32 CPU route: the depthwise twins' grouped convs and the channel
    products' matrix products) at a small width."""
    arch = _arch()
    model = arch.build(None, SMALL, "cpu")
    model.load_state_dict(arch.init_state(SMALL, 3, "cpu"))
    model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.rand((1,) + block))
    assert counter.get_total_flops() == arch.flops(SMALL, block)


def test_published_flops_and_d1_work():
    """The forward's FLOPs a voxel of a 128^3 block, and D1's work over a
    stack at the cell's tiles: 36 blocks of 128^3, per block 62 depthwise
    convs (78,234 FLOPs a voxel: 14.7% of the forward)."""
    arch = _arch()
    model = cells.load_cell(CELL).config["model"]
    assert arch.flops_per_voxel(model) == pytest.approx(532_967.263671875)
    calls = arch.dwconv_calls(model, (128, 128, 128))
    assert len(calls) == 62 and sum(t for *_, t in calls) == 4
    assert sum(1 for w, vi, vo, t in calls if vo * 8 == vi) == 4   # down
    f, b = arch.dwconv_work(model, (128, 128, 128))
    direct_f = direct_b = 0
    for name, c, side, stride, transposed, count in (
            ("level 0", 32, 128, 1, False, 6), ("level 1", 64, 64, 1, False, 8),
            ("level 2", 128, 32, 1, False, 16),
            ("level 3", 256, 16, 1, False, 16),
            ("level 4", 512, 8, 1, False, 8),
            ("down 0", 32, 128, 2, False, 1), ("down 1", 64, 64, 2, False, 1),
            ("down 2", 128, 32, 2, False, 1), ("down 3", 256, 16, 2, False, 1),
            ("up 3", 512, 8, 2, True, 1), ("up 2", 256, 16, 2, True, 1),
            ("up 1", 128, 32, 2, True, 1), ("up 0", 64, 64, 2, True, 1)):
        out = 2 * side - 1 if transposed else side // stride
        n_in, n_out = c * side ** 3, c * out ** 3
        direct_f += count * 250 * (n_in if transposed else n_out)
        direct_b += count * 2 * (n_in + n_out)
    assert (f, b) == (direct_f, direct_b)
    assert f / 128 ** 3 == pytest.approx(78_234.375)
    got = arch.work(model, "infer", shape=(96, 512, 512), tile=(96, 96, 96),
                    halo=(16, 16, 16))
    weights = sum(4 * 126 * w for w, *_ in calls)
    assert got == {"dwconv": (36 * f, 36 * b + weights)}
    assert arch.work(model, "train", batch=8, patch=(64, 64, 64)) == {}
    assert arch.program_overrides(model) == {}


def test_cell_loads_with_no_file_edited():
    w = {x["name"]: x for x in cells.benchmark()["workloads"]}[CELL]
    cell = _check_cell(w)
    assert cells.arch_name(cell.config) == "mednext"
    names = {m["name"] for m in cell.per_layer}
    assert {"mednext.full_ms", "mednext.deep_ms", "dwconv.roofline",
            "inorm.device_ms", "infer.sweep_ms", "infer.mfu",
            "device.idle.infer"} <= names
    assert not names & {"k4.roofline", "infer.net_ms", "swin.cnn_ms",
                        "wattn.roofline", "rconv.device_ms"}
    assert [m["name"] for m in cell.end_to_end] == ["infer_mvox_s",
                                                    "peak_mem_gib",
                                                    "setup_s"]
    s = cell.config["settings"]
    assert s["infer.tile_batch"] == 2 and all(
        t + 2 * h == 128 for t, h in zip(s["infer.tile"], s["infer.halo"]))


def _stage(per_call):
    return {"count": 36, "calls": 2, "timed_calls": 2,
            "sum_ms": 2 * per_call, "mean_ms": 2 * per_call / 36,
            "per_call_ms": per_call}


@pytest.mark.parametrize("name,stage", [("mednext.full_ms", "mednext.full"),
                                        ("mednext.deep_ms", "mednext.deep")])
def test_stage_readers_on_a_fake_snapshot(name, stage, monkeypatch):
    """A stage reader gives its stage's device ms per call, and None where
    the program recorded no such stage (the parent, another net)."""
    snap = {"stages": {"net": _stage(1.0), "mednext.full": _stage(300.0),
                       "mednext.deep": _stage(150.0)},
            "spans": {}, "counters": {}, "gauges": {}, "gauge_totals": {}}
    run = cells.Run(units=2, window_s=1.0, spans={}, counters={},
                    trace=None, work={})
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    assert cells.load_metric(name).read(run) == snap["stages"][stage][
        "per_call_ms"]
    snap["stages"] = {"net": _stage(100.0)}
    assert cells.load_metric(name).read(run) is None


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, patterns):
        assert patterns == ("dwconv_",)
        return self.seconds


def test_readers_read_nothing_without_a_record():
    run = cells.Run(units=2, window_s=1.0, spans={}, counters={},
                    trace=None, work={})
    for name in ("mednext.full_ms", "mednext.deep_ms", "dwconv.roofline"):
        assert cells.load_metric(name).read(run) is None
    w = (6e12, 1.1e11)
    run.trace, run.work = _Trace(0.0), {"dwconv": w}
    assert cells.load_metric("dwconv.roofline").read(run) is None
    run.trace = _Trace(0.2)
    assert cells.load_metric("dwconv.roofline").read(run) == pytest.approx(
        100.0 * work.roofline_seconds(*w) * 2 / 0.2)


def test_tiny_cell_runs_end_to_end_on_the_cpu():
    """The cell at n_channels 4 with one block a stage on two 32 x 64 x 64
    stacks of 32^3 blocks, weights from two reference steps, bf16 as
    configured: the program's labels equal the twin's and the reference
    post-processing's, and its probability maps are near the float32
    reference's (bf16 on a tiny cell)."""
    cell = cells.load_cell(CELL)
    c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    spec = copy.deepcopy(cell.spec)
    c["model"].update(n_channels=4, block_counts=[1] * 9)
    c["settings"].update({"infer.tile": [32, 32, 32],
                          "infer.halo": [0, 0, 0], "infer.tile_batch": 2})
    small = {"shape": [32, 64, 64], "count": 2, "nuclei": 6,
             "radius_range": [2.0, 3.0], "anisotropy": [0.6, 1.0, 1.0],
             "noise": 0.05, "min_center_dist": 5.0}
    t["volumes"] = small
    c["weights"].update(steps=2, volumes=dict(small, count=1))
    c["weights"]["data"].update(patch_size=[32, 32, 32], batch_size=2)
    c["name"] = "tiny-" + c["name"]
    spec["check"]["limits"].update(prob_gap_max=0.05, prob_gap_mean=0.01)
    tiny = cells.Cell(cell.name, cell.entry, spec, c, t, cell.end_to_end,
                      cell.per_layer)
    res = infer_cell.run(tiny, 5, 0.2, False, time.perf_counter(),
                         device="cpu")
    assert res.correct, res.checks
    assert res.attempted >= 1
    assert set(res.metrics) == {"infer_mvox_s", "peak_mem_gib", "setup_s"}
    assert math.isfinite(res.metrics["infer_mvox_s"]["value"])
