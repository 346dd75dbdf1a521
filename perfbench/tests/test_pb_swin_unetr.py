"""SwinUNETR behind the architecture seam (``arch/swin_unetr.py``): its
seeded state, its reference forward against the program's module, its work
counts, its cell loaded with no file edited, its readers, and a tiny
inference cell of it run end to end on the CPU."""

import copy
import time

import pytest
import torch

from perfbench import cells, infer_cell, program, work
from perfbench.tests.test_pb_files import _check_cell

SMALL = {"in_channels": 1, "out_channels": 2, "feature_size": 16,
         "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8],
         "window_size": 7, "patch_size": 2, "mlp_ratio": 4.0,
         "compute_dtype": "float32", "param_dtype": "float32"}
CELL = "infer-swin-stack600"


def _arch():
    return cells.load_arch("swin_unetr")


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


@pytest.mark.parametrize("shape", [(1, 32, 32, 32), (1, 32, 64, 32)])
def test_forward_is_the_programs_module(shape):
    """float32 on the CPU: the reference against the module the program
    builds (``build``) from the same state; sums in other orders, rtol and
    atol 1e-4 (``tests/test_torch_swin_unetr.py`` says why)."""
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
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key,value", [("window_size", 8),
                                       ("patch_size", 4),
                                       ("param_dtype", "bfloat16")])
def test_build_refuses_what_the_program_fixes(key, value):
    """Window 7, patch 2 and float32 parameters are the program's
    constants: a configuration that states another value is refused, not
    built as if it had not."""
    with pytest.raises(ValueError, match=key):
        _arch().build(None, dict(SMALL, **{key: value}), "cpu")


def test_flops_and_work():
    """The forward's FLOPs a voxel of a 96^3 block over unpadded tokens,
    and W1's work over a stack at the cell's tiles: 64 blocks of 96^3, per
    block 22.9 GFLOP and 133.8 MB over the padded grids (49^3, 28^3, 14^3
    and 6^3 tokens)."""
    arch = _arch()
    model = cells.load_cell(CELL).config["model"]
    assert arch.flops_per_voxel(model) == 712_491
    got = arch.work(model, "infer", shape=(96, 512, 512), tile=(96, 64, 64),
                    halo=(0, 16, 16))
    per_block = arch.wattn_work(model, (96, 96, 96))
    tables = 2 * 2197 * (3 + 6 + 12 + 24) * 4
    assert got == {"wattn": (64 * per_block[0], 64 * per_block[1] + tables)}
    flops, nbytes = per_block
    assert flops == 2 * 16 * 4 * (343 * 3 * 343 ** 2 + 64 * 6 * 343 ** 2
                                  + 8 * 12 * 343 ** 2 + 24 * 216 ** 2)
    assert nbytes == 2 * 2 * 4 * (49 ** 3 * 48 + 28 ** 3 * 96 + 14 ** 3 * 192
                                  + 6 ** 3 * 384)
    assert arch.work(model, "train", batch=8, patch=(64, 64, 64)) == {}
    assert arch.program_overrides(model) == {}


def test_cell_loads_with_no_file_edited():
    w = {x["name"]: x for x in cells.benchmark()["workloads"]}[CELL]
    cell = _check_cell(w)
    assert cells.arch_name(cell.config) == "swin_unetr"
    names = {m["name"] for m in cell.per_layer}
    assert {"swin.transformer_ms", "swin.cnn_ms", "wattn.roofline",
            "infer.sweep_ms", "infer.mfu", "device.idle.infer"} <= names
    assert not names & {"k4.roofline", "infer.net_ms"}
    assert [m["name"] for m in cell.end_to_end] == ["infer_mvox_s",
                                                    "peak_mem_gib",
                                                    "setup_s"]


def _stage(per_call):
    return {"count": 32, "calls": 2, "timed_calls": 2,
            "sum_ms": 2 * per_call, "mean_ms": 2 * per_call / 32,
            "per_call_ms": per_call}


@pytest.mark.parametrize("name,stage", [("swin.transformer_ms",
                                         "swin.transformer"),
                                        ("swin.cnn_ms", "swin.cnn")])
def test_stage_readers_on_a_fake_snapshot(name, stage, monkeypatch):
    """A stage reader gives its stage's device ms per call, and None where
    the program recorded no such stage (the parent, another net)."""
    snap = {"stages": {"net": _stage(1.0), "swin.transformer": _stage(150.0),
                       "swin.cnn": _stage(575.0)},
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
        assert patterns == ("window_attn_kernel",)
        return self.seconds


def test_readers_read_nothing_without_a_record():
    run = cells.Run(units=2, window_s=1.0, spans={}, counters={},
                    trace=None, work={})
    for name in ("swin.transformer_ms", "swin.cnn_ms", "wattn.roofline"):
        assert cells.load_metric(name).read(run) is None
    w = (1e12, 1e9)
    run.trace, run.work = _Trace(0.004), {"wattn": w}
    assert cells.load_metric("wattn.roofline").read(run) == pytest.approx(
        100.0 * work.roofline_seconds(*w) * 2 / 0.004)


def test_tiny_cell_runs_end_to_end_on_the_cpu():
    """The cell at feature 16 on two 32 x 64 x 64 stacks of 32^3 blocks,
    weights from two reference steps, bf16 as configured: the program's
    labels equal the twin's and the reference post-processing's, and its
    probability maps are near the float32 reference's (bf16 on a tiny
    cell: 0.022 worst, 0.0021 mean, read on the CPU)."""
    cell = cells.load_cell(CELL)
    c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    spec = copy.deepcopy(cell.spec)
    c["model"].update(feature_size=16, num_heads=[1, 2, 4, 8])
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
