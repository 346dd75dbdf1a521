"""The port's recorder (``tpuseg_torch/utils/profiling.py``): host spans,
device stage marks and counters, switched on by a ``torch.profiler``
session and by nothing else.

On the CPU: with no session nothing is recorded, no clock read and no
``record_function`` entered; under a session the spans carry their parent
and call ids and sit in the Chrome trace where the recorder put them, the
prefetch worker's spans too; the inference call and the train step mark
their stages in order; a captured program (on a stand-in backend) emits
its spans for eager, capture and replay; a graph's marks are harvested
when its replay has completed and counted as missed when it has not; the
exporter places a replay's stages at its launch's first device operation.
The test marked ``card`` holds the stage times of a real graph to CUDA
events around its replay and the placed stages to their kernels:
``python -m pytest tests/test_torch_profiling.py -m card --noconftest`` on
a machine with a card (this file imports nothing of JAX; the shared
``conftest.py`` does)."""

import json
import threading
import types

import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from tpuseg_torch.core import Config, DataConfig, ModelConfig, TrainConfig
from tpuseg_torch.core import InferConfig, PostprocConfig
from tpuseg_torch.data import PatchSampler, synthesize_volume
from tpuseg_torch.data.prefetch import BatchPrefetcher
from tpuseg_torch.infer import make_infer_fn
from tpuseg_torch.infer.graph import CapturedProgram, CudaGraphs
from tpuseg_torch.models import build_model
from tpuseg_torch.train import create_train_state, make_train_step
from tpuseg_torch.utils import profiling

TILE_BATCHES = 2      # (16, 32, 32) volumes in (8, 32, 32) tiles


@pytest.fixture(autouse=True)
def fresh_recorder():
    """One torch thread (test workers share the cores), and a recorder
    emptied before and after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield profiling.RECORDER
    profiling.reset()
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def session():
    """A CPU profiler session: the recorder's switch."""
    return profile(activities=[ProfilerActivity.CPU])


class Analytic(nn.Module):
    """Pointwise logits from blob intensities."""

    def forward(self, x):
        v = x[:, 0].float()
        return {"fg_logits": (v - 0.35) * 25.0,
                "peak_logits": (v - 0.75) * 25.0}


def _infer_cfg(program="fused"):
    return Config(
        infer=InferConfig(tile=(8, 32, 32), halo=4, compute_dtype="float32",
                          program=program),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16))


def _volume(seed=0):
    return torch.from_numpy(synthesize_volume(
        shape=(16, 32, 32), num_instances=6, radius_range=(3.0, 5.0),
        noise=0.0, seed=seed).image)


def _train_cfg(grad_accum=1):
    return Config(
        model=ModelConfig(features=(8, 16), head_features=8,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(16, 16, 16), batch_size=2,
                        max_instances=8, aug_zscale=(0.5, 1.0)),
        train=TrainConfig(total_steps=20, warmup_steps=10, lr=1e-3,
                          grad_accum=grad_accum))


def _sampler():
    vol = synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=5)
    return PatchSampler([vol], patch_size=(16, 16, 16), batch_size=2,
                        max_instances=8, seed=1)


def _upload(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _stages_by_call(rec):
    out = {}
    for st in sorted(rec.stages, key=lambda s: (s.call, s.index)):
        out.setdefault(st.call, []).append(st.name)
    return [names for _, names in sorted(out.items())]


class _Raise:
    def __init__(self, what):
        self.what = what

    def __call__(self, *a, **k):
        raise AssertionError(f"{self.what} used with no profiler session")


def test_no_session_records_nothing(monkeypatch, fresh_recorder):
    """No span, stage or counter, no clock read and no record_function,
    through an inference call, a train step and the prefetcher."""
    monkeypatch.setattr(profiling, "_clock", _Raise("the clock"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        _Raise("record_function"))
    infer = make_infer_fn(Analytic(), _infer_cfg())
    infer(_volume())
    cfg = _train_cfg()
    model = build_model(cfg.model, seed=7)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    with BatchPrefetcher(_sampler(), _upload, depth=2) as feed:
        for _ in range(2):
            step(state, feed.next(), 3)
    rec = fresh_recorder
    assert not rec.spans and not rec.stages and not rec.counters
    assert not rec.pending


def test_spans_carry_parent_and_call_ids(fresh_recorder):
    with session():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    by = {s.name: s for s in fresh_recorder.spans}
    assert by["b"].parent == by["a"].id and by["c"].parent == by["b"].id
    assert by["d"].parent == by["a"].id and by["a"].parent is None
    assert len({by[n].call for n in "abcd"}) == 1
    assert by["e"].call != by["a"].call and by["e"].parent is None
    for s in by.values():
        assert s.start_ns <= s.end_ns
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].end_ns \
        <= by["b"].end_ns <= by["a"].end_ns
    snap = profiling.snapshot()
    assert snap["spans"]["b"]["count"] == 1
    assert snap["spans"]["b"]["calls"] == 1


def test_the_trace_holds_each_span_at_its_recorded_times(tmp_path,
                                                        fresh_recorder):
    """``trace`` writes trace.json and spans.json; each span of the
    program is in the Chrome trace within 50 us of its recorded start and
    end, on the trace's clock."""
    infer = make_infer_fn(Analytic(), _infer_cfg())
    vol = _volume()
    infer(vol)
    with profiling.trace(str(tmp_path)):
        # the first span of a session pays the session's own set-up
        with profiling.span("warm-up"):
            pass
        infer(vol)
        infer(vol)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        data = json.load(f)
    with open(tmp_path / profiling.SPANS_FILE) as f:
        spans = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    events = sorted((e for e in data["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    mine = sorted((s for s in fresh_recorder.spans if s.name != "warm-up"),
                  key=lambda s: s.start_ns)
    assert [s.name for s in mine].count("program.call") == 2
    for s in mine:
        e = min((e for e in events if e["name"] == s.name),
                key=lambda e: abs(e["ts"] - (s.start_ns - base) / 1e3))
        assert abs(e["ts"] - (s.start_ns - base) / 1e3) <= 50, s.name
        assert abs(e["ts"] + e["dur"] - (s.end_ns - base) / 1e3) <= 50, \
            s.name
    assert len(spans["spans"]) == len(fresh_recorder.spans)
    assert spans["snapshot"]["spans"]["program.call"]["count"] == 2


def test_prefetch_worker_spans_are_in_the_trace(tmp_path, fresh_recorder):
    with BatchPrefetcher(_sampler(), _upload, depth=2) as feed:
        feed.next()
        with profiling.trace(str(tmp_path)):
            # past the queue and the batch the worker holds: the last two
            # were sampled and uploaded inside the session
            for _ in range(5):
                feed.next()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    main = threading.get_ident()
    worker = {s.thread for s in fresh_recorder.spans
              if s.name.startswith("feed.") and s.name != "feed.next"}
    assert worker and main not in worker
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"feed.next", "feed.sample", "feed.put"} <= names
    snap = profiling.snapshot()
    depth = snap["counters"]["feed.depth"]
    assert depth["count"] == 5 and 0 <= depth["mean"] <= 2
    assert snap["spans"]["feed.next"]["count"] == 5


@pytest.mark.parametrize("program", ["fused", "staged"])
def test_infer_records_its_stages_in_order(program, fresh_recorder):
    infer = make_infer_fn(Analytic(), _infer_cfg(program))
    vol = _volume()
    with session():
        infer(vol)
        infer(vol)
    calls = _stages_by_call(fresh_recorder)
    per_stack = (["norm"] + ["tile_glue", "net"] * TILE_BATCHES
                 + ["tile_glue", "watershed", "filter"])
    if program == "staged":       # each stack is two calls: net, post
        calls = [a + b for a, b in zip(calls[0::2], calls[1::2])]
    assert calls == [per_stack, per_stack]
    snap = profiling.snapshot()
    assert snap["stages"]["net"] == {"count": 2 * TILE_BATCHES, "calls": 2,
                                     "timed_calls": 0, "sum_ms": None}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_records_its_stages_per_microbatch(grad_accum,
                                                      fresh_recorder):
    cfg = _train_cfg(grad_accum)
    model = build_model(cfg.model, seed=7)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, grad_accum=grad_accum)
    sampler = _sampler()
    with session():
        for _ in range(2):
            step(state, _upload(sampler.next_batch()), 3)
    one = ["targets", "forward", "backward"] * grad_accum + ["optimizer"]
    assert _stages_by_call(fresh_recorder) == [one, one]
    names = [s.name for s in fresh_recorder.spans]
    assert names.count("step.call") == 2 and names.count("step.prepare") == 2
    by_id = {s.id: s for s in fresh_recorder.spans}
    for s in fresh_recorder.spans:
        if s.name in ("step.prepare", "program.call"):
            assert by_id[s.parent].name == "step.call"


class _StandInGraph:
    def __init__(self, fn, args):
        self.fn, self.args = fn, args


class StandIn:
    """A graph backend that takes CPU tensors: its capture runs the body
    and reserves ``RESERVED`` bytes, its replay runs the body again."""

    RESERVED = 3 * 2 ** 20

    @staticmethod
    def accepts(devices):
        return len(devices) == 1

    @staticmethod
    def new_pool():
        return object()

    @staticmethod
    def capture(fn, args, pool, device, generators=()):
        return _StandInGraph(fn, args), fn(*args), StandIn.RESERVED

    @staticmethod
    def replay(graph, device):
        graph.fn(*graph.args)

    @staticmethod
    def release(graphs):
        pass


def test_captured_program_spans_for_eager_capture_and_replay(fresh_recorder):
    before = _gauges("affine")
    prog = CapturedProgram(lambda x: {"y": x * 2}, backend=StandIn,
                           context=lambda: 0, name="affine")
    x = torch.ones(3)
    with session():
        for _ in range(3):
            prog(x)
    by_id = {s.id: s for s in fresh_recorder.spans}
    calls = {}
    for s in sorted(fresh_recorder.spans, key=lambda s: s.start_ns):
        if s.parent is not None:
            assert by_id[s.parent].name == "program.call"
            calls.setdefault(s.call, []).append(s.name)
    common = ["program.context"]
    graph = ["program.copy_in", "program.replay", "program.clone_out"]
    assert list(calls.values()) == [
        common + ["program.eager"], common + ["program.capture"] + graph,
        common + graph]
    snap = profiling.snapshot()
    assert snap["spans"]["program.prep"]["count"] == 2
    assert _gauges("affine", snap) == {
        "captures": before["captures"] + 1, "graphs": before["graphs"] + 1,
        "pool_bytes": before["pool_bytes"] + StandIn.RESERVED}
    prog.release()
    assert _gauges("affine") == {**before,
                                 "captures": before["captures"] + 1}
    prog(x)                      # eager again: the first sight of its key
    prog(x)
    del prog                     # a dropped program's graphs leave too
    assert _gauges("affine") == {**before,
                                 "captures": before["captures"] + 2}


def _gauges(owner, snap=None):
    """The program ``owner``'s gauges (they outlive ``reset``: tests
    compare against what was there before)."""
    snap = profiling.snapshot() if snap is None else snap
    return {"captures": 0, "graphs": 0, "pool_bytes": 0,
            **snap["gauges"].get(owner, {})}


def test_program_gauges_need_no_session(monkeypatch):
    monkeypatch.setattr(CudaGraphs, "capture", StandIn.capture)
    monkeypatch.setattr(CudaGraphs, "replay", StandIn.replay)
    monkeypatch.setattr(CudaGraphs, "accepts", StandIn.accepts)
    monkeypatch.setattr(CudaGraphs, "new_pool", StandIn.new_pool)
    before = {n: _gauges(n) for n in ("infer.net", "infer.post")}
    infer = make_infer_fn(Analytic(), _infer_cfg("staged"))
    vol = _volume()
    for _ in range(3):
        infer(vol)
    snap = profiling.snapshot()
    for name, was in before.items():
        assert _gauges(name, snap) == {
            "captures": was["captures"] + 1, "graphs": was["graphs"] + 1,
            "pool_bytes": was["pool_bytes"] + StandIn.RESERVED}
    assert snap["gauge_totals"]["pool_bytes"] >= 2 * StandIn.RESERVED


class _Event:
    """A stand-in CUDA event at a time in ms that has or has not run."""

    def __init__(self, ms, done=True):
        self.ms, self.done, self.waited = ms, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True

    def elapsed_time(self, other):
        return other.ms - self.ms


def _marks(done=True):
    marks = profiling.DeviceMarks()
    marks.marks = [("a", _Event(0.0)), ("b", _Event(1.5)), ("a", _Event(2.0)),
                   (profiling.END, _Event(4.0, done))]
    return marks


def test_a_completed_replay_is_harvested_and_a_running_one_missed(
        fresh_recorder):
    replay = types.SimpleNamespace(call=7, id=70)
    done = _marks()
    done.launched(replay)
    assert fresh_recorder.pending
    done.harvest()
    assert [(s.name, s.index, s.ms, s.call, s.launch)
            for s in fresh_recorder.stages] == [
        ("a", 0, 1.5, 7, 70), ("b", 1, 0.5, 7, 70), ("a", 2, 2.0, 7, 70)]
    running = _marks(done=False)
    running.launched(replay)
    running.harvest()
    assert fresh_recorder.counters["stages.missed"] == [1]
    assert len(fresh_recorder.stages) == 3 and not fresh_recorder.pending
    pending = _marks(done=False)
    pending.launched(replay)
    snap = profiling.snapshot()          # waits, then reads it
    assert pending.marks[-1][1].waited
    assert snap["stages"]["a"]["sum_ms"] == 7.0
    assert snap["stages"]["a"]["per_call_ms"] == 7.0
    assert snap["counters"]["stages.missed"]["count"] == 1


def test_a_call_reads_its_last_replays_marks_outside_its_prep(
        fresh_recorder):
    """A program's next call reads its last replay's marks in a
    ``program.harvest`` span, its first child, which ``program.prep``
    leaves out; a stage's ``per_call_ms`` is per call that timed it, not
    per call that ran it (an eager call records no time)."""
    prog = CapturedProgram(lambda x: {"y": x * 2}, backend=StandIn,
                           context=lambda: 0, name="harvested")
    x = torch.ones(3)
    for _ in range(2):                  # eager, capture
        prog(x)
    next(iter(prog.graphs.values())).marks.marks = _marks().marks
    with session():
        for _ in range(3):
            prog(x)
    rec = fresh_recorder
    calls = {s.id: s for s in rec.spans if s.name == profiling.CALL}
    firsts = {}
    for s in sorted(rec.spans, key=lambda s: s.start_ns):
        if s.parent in calls:
            firsts.setdefault(s.parent, s.name)
    assert sorted(firsts.values()) == ["program.context"] + [
        profiling.HARVEST] * 2
    harvest = {s.parent: s.end_ns - s.start_ns for s in rec.spans
               if s.name == profiling.HARVEST}
    prep_ns = sum(s.start_ns - calls[s.parent].start_ns
                  - harvest.get(s.parent, 0)
                  for s in rec.spans if s.name == profiling.REPLAY)
    rec.stages.append(profiling.Stage("a", 999, 0, None))   # eager
    snap = profiling.snapshot()         # reads the last replay's marks
    assert snap["spans"]["program.prep"]["sum_ms"] == pytest.approx(
        prep_ns / 1e6)
    a = snap["stages"]["a"]
    assert (a["count"], a["calls"], a["timed_calls"]) == (7, 4, 3)
    assert a["per_call_ms"] == pytest.approx(3.5)
    assert "stages.missed" not in rec.counters


def test_the_exporter_places_a_replays_stages_at_its_launch():
    base = 1_000_000_000
    replay = profiling.Span(profiling.REPLAY, base + 10_000, base + 30_000,
                            5, 4, 1, 0)
    stages = [profiling.Stage("net", 1, 1, 0.25, 5),
              profiling.Stage("norm", 1, 0, 0.5, 5),
              profiling.Stage("lost", 2, 0, 0.5, 99)]
    events = [
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 15.0,
         "args": {"correlation": 11}},
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 95.0,
         "args": {"correlation": 12}},
        {"name": "k2", "cat": "kernel", "ts": 140.0, "dur": 1.0,
         "args": {"correlation": 11}},
        {"name": "k1", "cat": "kernel", "ts": 120.0, "dur": 1.0,
         "args": {"correlation": 11}},
        {"name": "k3", "cat": "kernel", "ts": 100.0, "dur": 1.0,
         "args": {"correlation": 12}}]
    placed = profiling.place_stages(events, [replay], stages, base)
    assert [(st.name, ts, dur) for st, ts, dur in placed] == [
        ("norm", 120.0, 500.0), ("net", 620.0, 250.0)]


@pytest.mark.card
def test_stages_of_a_captured_graph_on_the_card(card, tmp_path):
    """Inside a captured inference graph (c3's fused bf16 call, K4, K1-K3),
    the stages of a replay sum to within 2% of CUDA events around the
    replay's launch, and the exporter's placed stages hold their kernels:
    K4's tensor-core body inside ``net``, K2's passes inside
    ``watershed``."""
    cfg = Config().override(**{
        "model.compute_dtype": "bfloat16", "infer.compute_dtype": "bfloat16",
        "infer.tile": [32, 64, 128], "infer.halo": [0, 8, 0],
        "infer.apply_impl": "fused", "postproc.peak_threshold": 0.35})
    model = build_model(cfg.model, seed=3).to(card).eval()
    vol = torch.from_numpy(synthesize_volume(
        shape=(32, 128, 128), num_instances=30, seed=1).image).to(card)
    infer = make_infer_fn(model, cfg)
    for _ in range(3):                 # eager, capture, replay
        infer(vol)
    torch.cuda.synchronize()
    graph = next(iter(infer.graphs.values()))
    launch, whole = graph._replay, []

    def timed():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        launch()
        ev[1].record()
        whole.append(ev)

    graph._replay = timed
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            # the previous replay done (its marks are read at this call),
            # the device sleeps while the host enqueues the call, so the
            # events time the graph and not the host
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            infer(vol)
        torch.cuda.synchronize()
    rec = profiling.RECORDER
    replays = sorted((s for s in rec.spans if s.name == profiling.REPLAY),
                     key=lambda s: s.start_ns)
    assert len(replays) == 3 and not rec.counters.get("stages.missed")
    for r, (a, b) in zip(replays, whole):
        stages = [s for s in rec.stages if s.launch == r.id]
        assert [s.name for s in stages][:2] == ["norm", "tile_glue"]
        total = sum(s.ms for s in stages)
        print(f"stages {total:.4f} ms, events around the replay "
              f"{a.elapsed_time(b):.4f} ms")
        assert abs(total - a.elapsed_time(b)) <= 0.02 * a.elapsed_time(b)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    placed = [e for e in events if e.get("cat") == "program_stage"]
    assert len(placed) == sum(1 for s in rec.stages if s.launch)
    tol = 10.0                          # us

    def inside(kernel, stage):
        spans = [(e["ts"] - tol, e["ts"] + e["dur"] + tol) for e in placed
                 if e["name"] == stage]
        found = [e for e in events if e.get("cat") == "kernel"
                 and kernel in e["name"] and e["ts"] > placed[0]["ts"] - tol]
        assert found, kernel
        for e in found:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in spans), (kernel, e["ts"])

    inside("convblock_mma_kernel", "net")
    inside("chase_pass_kernel", "watershed")
