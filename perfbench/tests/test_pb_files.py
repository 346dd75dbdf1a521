"""Every file of the benchmark loads, agrees with ``BENCHMARK.json`` and
keeps to the benchmark's contract, and a cell or a metric added as new
files is found without editing any other."""

import json
import re
import shutil

import pytest

from perfbench import cells

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


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_load(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and NAME.match(w["name"])
    assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    cell = cells.load_cell(w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    limits = cell.spec["check"]["limits"]
    assert limits and all(v >= 0 for v in limits.values())


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
        assert m["workloads"] == mod.WORKLOADS
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
        'UNIT = "ms"\nSOURCE = "host_clock"\nMOVES = "infer_mvox_s"\n'
        'WORKLOADS = ["infer-stack300"]\n\n\n'
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
