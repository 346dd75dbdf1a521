"""Every file of the benchmark loads, agrees with ``BENCHMARK.json`` and
keeps to the benchmark's contract, and a cell or a metric added as new
files is found without editing any other."""

import json
import re
import shutil

import pytest

from perfbench import cells, gen

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    data = cells.load_json(cells.ROOT / c["file"])
    assert c["file"].startswith("perfbench/configs/")
    assert data["name"] == c["name"] and data["source"] == c["source"]
    assert data["reduced"] == c["reduced"]
    assert data["kind"] in ("infer", "train")
    assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200


def _check_cell(w, bench=BENCH, here=cells.HERE):
    """A cell's entry keeps to the contract and its files load: its
    architecture, its generator, a set-up time, another end-to-end metric
    and a per-layer metric that moves one of them, and its check's
    limits."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and NAME.match(w["name"])
    assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    cell = cells.load_cell(w["name"], bench=bench, here=here)
    arch = cells.load_arch(cells.arch_name(cell.config), here=here)
    assert all(callable(getattr(arch, f)) for f in (
        "program_overrides", "build", "state_shapes", "init_state",
        "is_statistic", "forward", "flops_per_voxel", "work"))
    assert all((here / f).is_file() for f in arch.SOURCES)
    generator = cells.load_module(
        "generators", gen.generator(cell.traffic["volumes"]), here=here)
    assert callable(generator.make_volumes)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    limits = cell.spec["check"]["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    return cell


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_load(w):
    _check_cell(w)


def test_metrics():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert len(names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", cell_names)) <= cell_names
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert sorted(m["name"] for m in BENCH["per_layer"]) \
        == cells.metric_names()
    for m in BENCH["per_layer"]:
        mod = cells.load_metric(m["name"])
        assert (m["layer"], m["unit"], m["moves"], m["source"]) \
            == (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE)
        # the cells a metric is read in are listed here and nowhere else
        assert not hasattr(mod, "WORKLOADS")
        assert set(m["workloads"]) <= cell_names
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(v) <= 200 and "\n" not in v for v in layers)


def test_new_cell_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark with one more cell (a new mix) and one more
    metric, added as files and entries, loads them by name."""
    here = tmp_path / "perfbench"
    shutil.copytree(cells.HERE, here,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        shutil.copy(cells.ROOT / c["file"], tmp_path / c["file"])
    traffic = cells.load_json(here / "traffic" / "stack600.json")
    traffic["volumes"]["nuclei"] = 300
    (here / "traffic" / "stack300.json").write_text(json.dumps(traffic))
    spec = cells.load_json(here / "workloads" / "infer-stack600.json")
    spec["traffic"] = "stack300"
    (here / "workloads" / "infer-stack300.json").write_text(json.dumps(spec))
    (here / "metrics" / "infer.unit_ms.py").write_text(
        'LAYER = "infer pipeline (infer/pipeline.py, infer/graph.py)"\n'
        'UNIT = "ms"\nSOURCE = "host_clock"\nMOVES = "infer_mvox_s"\n\n\n'
        'def read(run):\n    return 1e3 * max(run.spans["unit"])\n')
    bench["workloads"].append({"name": "infer-stack300",
                               "config": spec["config"],
                               "traffic": "stack300", "chips": 1,
                               "why": "half the nuclei"})
    bench["per_layer"].append({"name": "infer.unit_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "infer pipeline (infer/pipeline.py,"
                                        " infer/graph.py)",
                               "moves": "infer_mvox_s",
                               "workloads": ["infer-stack300"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell("infer-stack300", here=here)
    assert cell.traffic["volumes"]["nuclei"] == 300
    assert [m["name"] for m in cell.per_layer] == ["infer.unit_ms"]
    run = cells.Run(units=2, window_s=1.0, spans={"unit": [0.1, 0.2]},
                    counters={}, trace=None, work={})
    assert cells.load_metric("infer.unit_ms", here=here).read(run) == 200.0
    assert "infer.unit_ms" in cells.metric_names(here)


def test_a_file_that_disagrees_is_refused(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "ls201"
    with pytest.raises(ValueError):
        cells.load_cell(bench["workloads"][0]["name"], bench=bench)
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell")


#: an architecture written as a new file: one 3x3x3 conv with bias and
#: ReLU, a 1x1x1 two-channel head, its reference forward beside the model
TINY_ARCH = '''"""A tiny architecture: a 3x3x3 conv, ReLU, a 1x1x1 head."""

import math

import torch
import torch.nn.functional as F

SOURCES = ("arch/tinynet.py",)
WIDTH = 4


def program_overrides(model):
    return {}


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(1, WIDTH, 3, padding=1)
        self.head = torch.nn.Conv3d(WIDTH, 2, 1)

    def forward(self, x):
        if x.dim() == 4:
            x = x[:, None]
        y = self.head(torch.relu(self.conv(x.float())))
        return {"fg_logits": y[:, 0], "peak_logits": y[:, 1]}


def build(cfg, model, device):
    return TinyNet().to(device)


def state_shapes(model):
    return {"conv.weight": (WIDTH, 1, 3, 3, 3), "conv.bias": (WIDTH,),
            "head.weight": (2, WIDTH, 1, 1, 1), "head.bias": (2,)}


def init_state(model, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return {k: (torch.randn(s, generator=g, device=device)
                / math.sqrt(math.prod(s[1:])) if len(s) == 5
                else torch.zeros(s, device=device))
            for k, s in state_shapes(model).items()}


def is_statistic(name):
    return False


def forward(p, x, model, train=False, stats=None, quant=None):
    q = quant or (lambda t: t)
    if x.dim() == 4:
        x = x[:, None]
    h = torch.relu(F.conv3d(q(x), q(p["conv.weight"]), p["conv.bias"],
                            padding=1))
    y = F.conv3d(q(h), q(p["head.weight"]), p["head.bias"])
    return {"fg_logits": y[:, 0], "peak_logits": y[:, 1]}


def flops_per_voxel(model):
    return 2 * 27 * WIDTH + 2 * WIDTH * 2


def work(model, kind, **shapes):
    return {}
'''

RUN_TINY = '''
import json, sys, time
from perfbench import cells, infer_cell, train_cell
out = {"here": str(cells.HERE)}
for name, driver in (("tiny-infer", infer_cell), ("tiny-train", train_cell)):
    res = driver.run(cells.load_cell(name), 5, 0.2, False, time.perf_counter(),
                     device="cpu")
    out[name] = {"correct": res.correct, "attempted": res.attempted,
                 "checks": res.checks}
print(json.dumps(out))
'''


def _tiny_files(here, bench):
    """The tiny architecture's configurations, mixes and cells, as files
    and ``BENCHMARK.json`` entries."""
    from perfbench.tests.tiny import SMALL

    (here / "arch" / "tinynet.py").write_text(TINY_ARCH)
    infer = cells.load_json(here / "configs"
                            / "unet3d-dong2019-infer-bf16.json")
    train = cells.load_json(here / "configs"
                            / "unet3d-dong2019-train-bf16.json")
    for c, name in ((infer, "tinynet-infer"), (train, "tinynet-train")):
        c.update(name=name, arch="tinynet", model={})
    infer["settings"].update({"infer.tile": [8, 16, 32],
                              "infer.halo": [0, 4, 0],
                              "infer.compute_dtype": "float32",
                              "infer.apply_impl": "flax"})
    infer["weights"].update(steps=2, volumes=dict(SMALL["nuclei"], count=1))
    infer["weights"]["data"].update(patch_size=[8, 16, 16], batch_size=2)
    train["settings"].update({"train.apply_impl": "flax",
                              "train.log_every": 2})
    mixes = {"tiny-stacks": {"volumes": SMALL["nuclei"]},
             "tiny-patches": {"settings": {"data.batch_size": 2,
                                           "data.patch_size": [8, 16, 16]},
                              "volumes": dict(SMALL["nuclei"],
                                              shape=[16, 24, 24])}}
    infer_check = {"samples": 1, "limits": {
        "pct_gap": 0.0, "prob_gap_max": 1e-4, "prob_gap_mean": 1e-5,
        "label_mismatch": 0.0, "twin_label_mismatch": 0.0}}
    train_check = {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                              "param_change_gap": 1e-3, "bn_stats_gap": 0.0}}
    for c, cell, mix, check in (
            (infer, "tiny-infer", "tiny-stacks", infer_check),
            (train, "tiny-train", "tiny-patches", train_check)):
        (here / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        (here / "traffic" / f"{mix}.json").write_text(json.dumps(mixes[mix]))
        (here / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": c["name"], "traffic": mix, "chips": 1, "why": "tiny",
             "trace_units": 2, "check": check}))
        bench["configs"].append({"name": c["name"], "source": c["source"],
                                 "file": f"perfbench/configs/{c['name']}.json",
                                 "reduced": [], "why": "a tiny architecture"})
        bench["workloads"].append({"name": cell, "config": c["name"],
                                   "traffic": mix, "chips": 1, "why": "tiny"})
    # each tiny cell joins every metric of the cell of its kind, by its name
    # in the metric's list in BENCHMARK.json alone
    for like, cell in (("infer-stack600", "tiny-infer"),
                       ("train-b8-p64", "tiny-train")):
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)


def test_new_architecture_needs_only_new_files(tmp_path):
    """A copy of the benchmark with a tiny architecture added as one file
    under ``arch/``, with configurations, mixes and cells that name it and
    join the existing metrics in ``BENCHMARK.json``, loads each cell as
    :func:`test_cells_load` does and runs a tiny inference cell and a tiny
    train cell of it end to end on the CPU, each ``correct`` against the
    architecture's own reference (both float32); every file the copy had is
    left as it was."""
    import os
    import subprocess
    import sys

    here = tmp_path / "perfbench"
    shutil.copytree(cells.HERE, here,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    _tiny_files(here, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    joined = {"tiny-infer": {"infer.net_ms", "infer.post_ms", "infer.mfu"},
              "tiny-train": {"train.forward_ms", "train.mfu"}}
    for w in bench["workloads"][-2:]:
        cell = _check_cell(w, bench, here)
        assert joined[w["name"]] <= {m["name"] for m in cell.per_layer}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(cells.ROOT)]))
    out = subprocess.run([sys.executable, "-c", RUN_TINY], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["here"] == str(here)
    for name in ("tiny-infer", "tiny-train"):
        assert got[name]["correct"], got[name]
        assert got[name]["attempted"] >= 1
    assert all((here / rel).read_bytes() == data
               for rel, data in before.items())
