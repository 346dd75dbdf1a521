"""The readers of the program's own record (``program.py`` and the
metrics that read ``tpuseg_torch.utils.profiling.snapshot()``): each on a
fake snapshot, None where what it reads is absent, and None from a
program that has no recorder."""

import types

import pytest

from perfbench import cells, program

RUN = cells.Run(units=4, window_s=1.0, spans={}, counters={}, trace=None,
                work={})


def _stage(per_call):
    return {"count": 3, "calls": 2, "timed_calls": 2, "sum_ms": 2 * per_call,
            "mean_ms": 2 * per_call / 3, "per_call_ms": per_call}


def _span(count, sum_ms):
    return {"count": count, "calls": count, "timed_calls": count,
            "sum_ms": sum_ms,
            "mean_ms": sum_ms / count, "per_call_ms": sum_ms / count}


SNAP = {
    "stages": {"norm": _stage(0.5), "net": _stage(140.0),
               "tile_glue": _stage(3.0), "watershed": _stage(3.8),
               "filter": _stage(0.2), "targets": _stage(8.0),
               "forward": _stage(15.0), "backward": _stage(30.0),
               "optimizer": _stage(6.0)},
    "spans": {"program.prep": _span(8, 2.4), "step.call": _span(20, 1100.0),
              "program.replay": _span(20, 1000.0), "feed.put": _span(21, 42.0)},
    "counters": {"feed.depth": {"count": 20, "sum": 30, "mean": 1.5}},
    "gauges": {"infer.net": {"captures": 1, "graphs": 1,
                             "pool_bytes": 2 * 2 ** 30},
               "infer.post": {"captures": 1, "graphs": 1,
                              "pool_bytes": 2 ** 30}},
    "gauge_totals": {"captures": 2, "graphs": 2, "pool_bytes": 3 * 2 ** 30}}

WANT = {"infer.norm_ms": 0.5, "infer.net_ms": 140.0,
        "infer.tile_glue_ms": 3.0, "infer.watershed_ms": 3.8,
        "infer.filter_ms": 0.2, "infer.host_prep_ms": 2.4 / 4,
        "infer.graph_pool_gib": 3.0, "train.targets_ms": 8.0,
        "train.forward_ms": 15.0, "train.backward_ms": 30.0,
        "train.optimizer_ms": 6.0, "train.step_host_ms": 5.0,
        "train.feed_depth": 1.5, "train.feed_put_ms": 2.0}


def test_every_reader_of_the_program_is_listed():
    readers = {m for m in cells.metric_names()
               if "perfbench import program" in
               (cells.HERE / "metrics" / f"{m}.py").read_text()}
    assert readers == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_fake_snapshot(name, monkeypatch):
    monkeypatch.setattr(program, "snapshot", lambda: SNAP)
    got = cells.load_metric(name).read(RUN)
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_what_it_reads(name, monkeypatch):
    """No stage, span or counter of its name (a snapshot of another cell,
    or a program that recorded nothing): None, and no error."""
    empty = {"stages": {}, "spans": {}, "counters": {},
             "gauges": {}, "gauge_totals": {}}
    monkeypatch.setattr(program, "snapshot", lambda: empty)
    got = cells.load_metric(name).read(RUN)
    assert got is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_program_without_the_recorder(name, monkeypatch):
    """A program older than the recorder has ``profiling`` without
    ``snapshot``: every reader gives None."""
    import tpuseg_torch.utils

    monkeypatch.setattr(tpuseg_torch.utils, "profiling",
                        types.SimpleNamespace(), raising=False)
    import sys

    monkeypatch.setitem(sys.modules, "tpuseg_torch.utils.profiling",
                        types.SimpleNamespace())
    assert program.snapshot() is None
    assert cells.load_metric(name).read(RUN) is None


def test_graph_pool_of_released_graphs_reads_none(monkeypatch):
    """Captures made, every graph released since: no pool to read."""
    snap = {"gauges": {"infer": {"captures": 2, "graphs": 0,
                                 "pool_bytes": 0}},
            "gauge_totals": {"captures": 2, "graphs": 0, "pool_bytes": 0}}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    assert cells.load_metric("infer.graph_pool_gib").read(RUN) is None


def test_stage_without_times_reads_none(monkeypatch):
    """A stage recorded on the CPU has no time: None, not 0."""
    snap = {"stages": {"net": {"count": 2, "calls": 1, "sum_ms": None}}}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    assert program.stage_ms("net") is None
