"""What a run is made of, found by name, and how a run reports.

``BENCHMARK.json`` names each cell with its configuration and traffic mix;
the files are ``workloads/<cell>.json`` (the cell's own settings: its
traced units, its output check's sample and limits), ``configs/<config>.json``
and ``traffic/<mix>.json``. Code that belongs to one name is a module of
its own, loaded by file path:

* ``arch/<name>.py``: an architecture, named by a configuration's ``arch``
  key (``unet3d`` where it has none). It builds the program's model,
  draws and names its state, holds the plain float32 reference forward and
  counts its work (:func:`load_arch`). The drivers, the weights and the
  reference trainer reach the model only through it.
* ``generators/<name>.py``: a traffic generator, named by a mix's
  ``volumes.generator`` key (``nuclei`` where it has none), read by
  ``gen.volumes_for``.
* ``metrics/<name>.py``: one per-layer metric's reader: ``LAYER``,
  ``UNIT``, ``MOVES``, ``SOURCE`` and ``read(run) -> float | None``. The
  cells a metric is read in are its ``workloads`` in ``BENCHMARK.json``,
  and only there.

Adding a cell, a configuration, an architecture, a mix, a generator or a
metric adds files and ``BENCHMARK.json`` entries (a new cell joins a
metric by its name in that metric's ``workloads``); nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
#: top-level module names the run's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "tpuseg")
#: set-up's phases as a run reaches their ends: (name, seconds since
#: ``T0``, the process start, which ``run.py`` sets)
PHASES: list = []
T0 = time.perf_counter()


def phase(name: str) -> None:
    """Mark the end of a set-up phase (:func:`emit` prints them)."""
    PHASES.append((name, time.perf_counter() - T0))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    entry: dict       # the BENCHMARK.json workload entry
    spec: dict        # workloads/<name>.json
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<mix>.json
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: dict | None = None,
              here: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    KeyError for a name the benchmark does not hold and ValueError where
    a file disagrees with its entry."""
    bench = bench if bench is not None else benchmark(here.parent)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    spec = load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {spec[key]!r} "
                             f"!= BENCHMARK.json's {entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(here.parent / configs[entry["config"]]["file"])
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    # a mix may restate settings of how work arrives (batch, patch size)
    config = {**config, "settings": {**config["settings"],
                                     **traffic.get("settings", {})}}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, entry, spec, config, traffic, e2e, layer)


#: each module :func:`load_module` has executed, by its file's path
_MODULES: dict = {}


def load_module(folder: str, name: str, here: Path = HERE):
    """The module of ``<folder>/<name>.py``, executed once a process;
    raises FileNotFoundError for a name that has no file there."""
    path = here / folder / f"{name}.py"
    if path in _MODULES:
        return _MODULES[path]
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py in {here}")
    modname = f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    # classes and dataclasses look their module up while they are made
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


def load_metric(name: str, here: Path = HERE):
    """The module of ``metrics/<name>.py``."""
    return load_module("metrics", name, here)


def arch_name(config: dict) -> str:
    """A configuration's architecture: its ``arch`` key, or the U-Net."""
    return config.get("arch", "unet3d")


def load_arch(name: str, here: Path = HERE):
    """The module of ``arch/<name>.py``: ``program_overrides(model)``,
    ``build(cfg, model, device)``, ``state_shapes(model)``,
    ``init_state(model, seed, device)``, ``is_statistic(name)``,
    ``forward(p, x, model, train=False, stats=None, quant=None)``,
    ``flops_per_voxel(model)``, ``work(model, kind, **shapes)`` and
    ``SOURCES``; ``model`` is a configuration's ``model`` group."""
    return load_module("arch", name, here)


def metric_names(here: Path = HERE) -> list:
    return sorted(p.stem for p in (here / "metrics").glob("*.py"))


def sections(config: dict) -> dict:
    """A configuration's stated settings by section (``model`` and each
    ``<section>.<key>`` of ``settings``), as the reference reads them."""
    out = {"model": dict(config["model"])}
    for key, value in config["settings"].items():
        sec, k = key.split(".", 1)
        out.setdefault(sec, {})[k] = value
    return out


def program_config(config: dict, **extra):
    """The program's ``Config`` with every stated setting applied: the
    architecture's ``model.*`` overrides, then the ``settings``."""
    from tpuseg_torch.core import Config

    arch = load_arch(arch_name(config))
    sets = dict(arch.program_overrides(config["model"]))
    sets.update(config["settings"])
    sets["train.ckpt_dir"] = str(CACHE / "ckpt")
    sets.update(extra)
    return Config().override(**sets)


@dataclass
class Run:
    """What a per-layer metric reads: the traced window's ``units``
    (stacks or steps) and host-clock length, the benchmark's spans and the
    program's counters per unit, the reduced trace, and the work one unit
    does (``work.py``)."""

    units: int
    window_s: float
    spans: dict
    counters: dict
    trace: object
    work: dict


def read_metrics(cell: Cell, run: Run) -> dict:
    out = {}
    for m in cell.per_layer:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def reset_peak(device) -> None:
    """Start the memory peak at the program's set-up: the first run of a
    checkout trains the weights, and the generator's temporaries fall in
    blocks whose sizes follow the draw. The inputs stay counted."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def device_record(cell: Cell, device, peak: int) -> dict:
    """The result's ``device``: the card's name, the cards used and the
    peak of reserved device memory."""
    import torch

    cuda = torch.device(device).type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Top-level names of loaded modules the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list              # (name, value, limit), compared value <= limit
    breakdown: dict | None = None


def emit(result: Result) -> None:
    """The result line last on stdout, the compared numbers last on
    stderr."""
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": result.metrics,
            "device": result.device}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in result.checks}
    sys.stdout.flush()
    if PHASES:
        ends = [0.0] + [t for _, t in PHASES]
        print("setup phases (s): " + ", ".join(
            f"{name} {t - t0:.3f}" for (name, t), t0 in zip(PHASES, ends)),
            file=sys.stderr)
    for name, v, lim in result.checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
