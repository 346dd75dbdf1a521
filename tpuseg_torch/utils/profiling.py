"""Profiling (port of ``tpuseg/utils/profiling.py``): a Chrome trace of a
``torch.profiler`` session, and the program's own record of what it did
in it.

``trace(log_dir)`` profiles a block (host and, with a card, device) and
writes ``<log_dir>/trace.json`` and ``<log_dir>/spans.json``. Once the
profiler has traced, later launches of the process cost the host more
(measured on an H100: the train step read 20-30% slower afterwards), so
trace last.

The recorder (one per process, :data:`RECORDER`) records while a
``torch.profiler`` session is active, whoever opened it: its switch is
torch's own flag (``torch.autograd.profiler._is_profiler_enabled``), so it
adds no setting. With no session a span site costs that one check: no
clock is read, no ``record_function`` entered, nothing allocated. Three
kinds of record:

* host spans, :func:`span`: name, start, end (``time.time_ns``, the clock
  the profiler stamps its trace with), parent span and call id; the
  outermost span of a thread opens a call, and its spans share the call's
  id. Each span also enters ``torch.profiler.record_function``, so it sits
  on the trace's timeline beside the device's operations;
* device stage marks, :func:`mark`: a stage starts at its mark and ends at
  the next mark of its call. Inside a CUDA graph capture a mark is taken
  in always, as a timing event's record node (``external=True``), so every
  replay times its stages. A replay's marks are read (harvested) at the
  start of its program's next call, in a span of their own
  (:data:`HARVEST`), before the graph can be launched again: if the replay
  has completed (``query()``, no wait), or else counted as missed
  (``stages.missed``), as the next replay overwrites them;
  :func:`snapshot` waits for the device and reads what is pending. Outside
  a capture (an eager call, the CPU) a mark records the stage's name and
  order, and no time;
* counters (:func:`count`, samples under a session; ``stages.missed``
  always) and gauges (:func:`gauge`, always: values their owners add to
  and take from, such as a captured program's captures, live graphs and
  the bytes those reserved in the graph pool).

The records gather over every session since the last :func:`reset`;
``trace`` resets at its start. :func:`snapshot` sums them per name.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
#: the stage name of the mark that ends a call's last stage
END = "end"
#: the span whose start, less its parent ``program.call``'s, is
#: :func:`snapshot`'s ``program.prep``
REPLAY = "program.replay"
CALL = "program.call"
#: a ``program.call``'s reading of its previous replays' marks, which
#: ``program.prep`` leaves out
HARVEST = "program.harvest"
#: the clock of the spans: the one ``torch.profiler`` stamps its trace with
_clock = time.time_ns
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a ``torch.profiler`` session is active (the recorder's only
    switch)."""
    return _autograd_profiler._is_profiler_enabled


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int
    thread: int


@dataclass
class Stage:
    """A stage of a call: its place among the call's marks (``index``) and,
    on the card, its device milliseconds. ``launch`` is the id of the
    ``program.replay`` span whose graph ran it (None when eager)."""

    name: str
    call: int
    index: int
    ms: float | None
    launch: int | None = None


class DeviceMarks:
    """The marks a CUDA graph capture took into its graph, ``(stage,
    event)`` in order, ending in :data:`END`; ``launch`` is the replay span
    whose marks wait to be harvested, or None."""

    def __init__(self):
        self.marks, self.launch, self.device = [], None, None

    def launched(self, replay: "_Open") -> None:
        """A replay under a session ran these marks."""
        if self.marks:
            self.launch = replay
            RECORDER.pending[id(self)] = self

    def harvest(self, wait: bool = False) -> None:
        """Record the last replay's stages if it has completed (with
        ``wait``, after waiting for it), else count a missed harvest."""
        replay, self.launch = self.launch, None
        RECORDER.pending.pop(id(self), None)
        if replay is None:
            return
        last = self.marks[-1][1]
        if wait:
            last.synchronize()
        elif not last.query():
            RECORDER.count("stages.missed", 1, always=True)
            return
        RECORDER.add_stages(self.marks, replay.call, replay.id)


class _Open:
    """A span being recorded (:func:`span` under a session)."""

    __slots__ = ("name", "id", "parent", "call", "start", "_fn", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = RECORDER
        stack = rec.stack()
        top = stack[-1] if stack else None
        self.id = next(rec.ids)
        self.parent = top.id if top else None
        self.call = top.call if top else next(rec.calls)
        self._stack = stack
        stack.append(self)
        before = _clock()
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        # the trace stamps the start inside the enter: its midpoint is
        # within half the enter's time of it
        self.start = (before + _clock()) // 2
        return self

    def __exit__(self, *exc):
        self._fn.__exit__(*exc)
        end = _clock()  # the trace stamps the end early in the exit
        self._stack.pop()
        rec = RECORDER
        rec.spans.append(Span(self.name, self.start, end, self.id,
                              self.parent, self.call,
                              threading.get_ident()))
        return False


class Recorder:
    """What the process recorded since the last :meth:`reset` (module
    docstring). Appends are atomic under the interpreter lock; the counts
    and gauges that add take :attr:`lock`. :meth:`reset` keeps the
    gauges."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids, self.calls = itertools.count(1), itertools.count(1)
        self.capture: DeviceMarks | None = None
        self.gauges: dict[str, dict[str, float]] = {}
        self.reset()

    def reset(self) -> None:
        for marks in getattr(self, "pending", {}).values():
            marks.launch = None
        self.spans, self.stages, self.counters = [], [], {}
        self.pending = {}
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, name: str, value: float, always: bool = False) -> None:
        if always or enabled():
            with self.lock:
                self.counters.setdefault(name, []).append(value)

    def gauge(self, owner: str, name: str, by: float) -> None:
        with self.lock:
            g = self.gauges.setdefault(owner, {})
            g[name] = g.get(name, 0) + by

    def add_stages(self, marks, call: int, launch: int | None) -> None:
        """Record the stages between consecutive ``(stage, event)`` marks."""
        self.stages.extend(
            Stage(stage, call, i, ev.elapsed_time(marks[i + 1][1]), launch)
            for i, (stage, ev) in enumerate(marks[:-1]))

    def mark(self, stage: str, like: torch.Tensor) -> None:
        if self.capture is not None and like.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record(torch.cuda.current_stream(like.device))
            self.capture.marks.append((stage, ev))
            self.capture.device = like.device
            return
        stack = self.stack()
        if not stack or not enabled():
            return
        call = stack[-1].call
        last = getattr(self._local, "last", None)
        index = last[1] + 1 if last is not None and last[0] == call else 0
        self._local.last = (call, index)
        self.stages.append(Stage(stage, call, index, None))

    def snapshot(self) -> dict:
        for marks in list(self.pending.values()):
            marks.harvest(wait=True)
        return {"spans": _stats(self.spans, _ms_of_span)
                | _prep(self.spans),
                "stages": _stats(self.stages, lambda s: s.ms),
                "counters": {k: {"count": len(v), "sum": sum(v),
                                 "mean": sum(v) / len(v)}
                             for k, v in list(self.counters.items())},
                **self.gauge_values()}

    def gauge_values(self) -> dict:
        """``gauges`` per owner and name, and ``gauge_totals`` per name
        over the owners."""
        with self.lock:
            gauges = {o: dict(g) for o, g in self.gauges.items()}
        totals = {}
        for g in gauges.values():
            for name, v in g.items():
                totals[name] = totals.get(name, 0) + v
        return {"gauges": gauges, "gauge_totals": totals}


def _ms_of_span(s: Span) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def _stats(records, ms_of) -> dict:
    """Per name: ``count``, ``calls`` (distinct call ids), and where times
    were recorded ``timed_calls`` (the calls with a time: on a card the
    replays whose marks were read), ``sum_ms``, ``mean_ms`` (per timed
    record) and ``per_call_ms`` (per timed call)."""
    out = {}
    for r in list(records):
        s = out.setdefault(r.name, {"count": 0, "calls": set(), "sum_ms": 0.0,
                                    "timed": 0, "timed_calls": set()})
        s["count"] += 1
        s["calls"].add(r.call)
        ms = ms_of(r)
        if ms is not None:
            s["sum_ms"] += ms
            s["timed"] += 1
            s["timed_calls"].add(r.call)
    for s in out.values():
        timed, s["calls"] = s.pop("timed"), len(s["calls"])
        s["timed_calls"] = len(s["timed_calls"])
        if timed:
            s["mean_ms"] = s["sum_ms"] / timed
            s["per_call_ms"] = s["sum_ms"] / s["timed_calls"]
        else:
            s["sum_ms"] = None
    return out


def _prep(spans) -> dict:
    """``program.prep``: the host time of each ``program.call`` from its
    start to the start of its ``program.replay``, less its
    ``program.harvest``."""
    calls = {s.id: s for s in spans if s.name == CALL}
    harvest = {}
    for s in spans:
        if s.name == HARVEST and s.parent in calls:
            harvest[s.parent] = (harvest.get(s.parent, 0)
                                 + s.end_ns - s.start_ns)
    prep = [Span("program.prep",
                 calls[s.parent].start_ns + harvest.get(s.parent, 0),
                 s.start_ns, 0, None, s.call, 0)
            for s in spans if s.name == REPLAY and s.parent in calls]
    return _stats(prep, _ms_of_span)


#: the process's recorder
RECORDER = Recorder()


def span(name: str):
    """A host span named ``name`` around a ``with`` block (module
    docstring); with no session a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name)


def mark(stage: str, like: torch.Tensor) -> None:
    """Start the device stage ``stage`` on the stream of ``like``'s device
    (module docstring): always inside a CUDA graph capture, otherwise only
    under a session and inside a span."""
    if RECORDER.capture is None and not _autograd_profiler._is_profiler_enabled:
        return
    RECORDER.mark(stage, like)


def mark_end() -> None:
    """End a capture's last stage: called inside the capture, after the
    body."""
    marks = RECORDER.capture
    if marks is not None and marks.marks:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(torch.cuda.current_stream(marks.device))
        marks.marks.append((END, ev))


@contextlib.contextmanager
def capturing():
    """The marks of a capture made in the ``with`` block (a
    :class:`DeviceMarks`)."""
    marks = DeviceMarks()
    outer, RECORDER.capture = RECORDER.capture, marks
    try:
        yield marks
    finally:
        RECORDER.capture = outer


def count(name: str, value: float) -> None:
    """A sample of the counter ``name`` (under a session)."""
    RECORDER.count(name, value)


def gauge(owner: str, name: str, by: float) -> None:
    """Add ``by`` to the gauge ``name`` of ``owner``, session or not."""
    RECORDER.gauge(owner, name, by)


def reset() -> None:
    """Drop every span, stage and counter sample recorded so far."""
    RECORDER.reset()


def snapshot() -> dict:
    """The records summed per name (waits for the device to read pending
    marks): ``spans`` and ``stages`` as :func:`_stats` gives them (spans
    add ``program.prep``), ``counters`` (``count``, ``sum``, ``mean``),
    ``gauges`` and ``gauge_totals`` (:meth:`Recorder.gauge_values`)."""
    return RECORDER.snapshot()


def _session_config() -> dict:
    """Profile every thread where this torch can: the prefetch worker's
    spans then sit in the trace too."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the ``with`` body into ``<log_dir>/trace.json`` (Chrome /
    Perfetto format) and write the recorder's records of it to
    ``<log_dir>/spans.json`` (:func:`export`); a no-op for ``None``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities, **_session_config()) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    export(path, os.path.join(log_dir, SPANS_FILE))


def place_stages(events: list, spans, stages, base_ns: int) -> list:
    """Each timed stage of a replay on the trace's timeline: its call's
    first mark at the start of the first device operation launched by the
    ``cudaGraphLaunch`` inside the replay span, the rest after it by the
    stages' times. ``[(stage, ts us, dur us)]``; a replay whose launch or
    device operations the trace lacks places nothing."""
    launches = sorted((float(e["ts"]), e["args"]["correlation"])
                      for e in events if e.get("name") == "cudaGraphLaunch"
                      and "correlation" in e.get("args", {}))
    first = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                first[c] = min(first.get(c, float("inf")), float(e["ts"]))
    replays = {s.id: s for s in spans if s.name == REPLAY}
    by_launch = {}
    for st in stages:
        if st.launch in replays and st.ms is not None:
            by_launch.setdefault(st.launch, []).append(st)
    out = []
    for launch, group in by_launch.items():
        r = replays[launch]
        a, b = (r.start_ns - base_ns) / 1e3, (r.end_ns - base_ns) / 1e3
        inside = [c for ts, c in launches if a <= ts <= b and c in first]
        if not inside:
            continue
        t = first[inside[0]]
        for st in sorted(group, key=lambda s: s.index):
            out.append((st, t, st.ms * 1e3))
            t += st.ms * 1e3
    return out


def export(trace_path: str, spans_path: str) -> None:
    """Write the records to ``spans_path`` on the trace's clock (``ts`` and
    ``dur`` in microseconds, as ``trace_path`` has them), place the device
    stages (:func:`place_stages`) and add them to the trace as events of
    category ``program_stage``."""
    snap = snapshot()
    with open(trace_path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    events = data["traceEvents"]
    rec = RECORDER
    placed = place_stages(events, rec.spans, rec.stages, base)
    pid = next((e["pid"] for e in events
                if e.get("cat") == "kernel"), "device")
    events.extend({"ph": "X", "cat": "program_stage", "name": st.name,
                   "pid": pid, "tid": "program stages", "ts": ts, "dur": dur,
                   "args": {"call": st.call, "index": st.index}}
                  for st, ts, dur in placed)
    with open(trace_path, "w") as f:
        json.dump(data, f)
    where = {id(st): (ts, dur) for st, ts, dur in placed}
    out = {"spans": [{"name": s.name, "ts": (s.start_ns - base) / 1e3,
                      "dur": (s.end_ns - s.start_ns) / 1e3, "id": s.id,
                      "parent": s.parent, "call": s.call, "thread": s.thread}
                     for s in rec.spans],
           "stages": [{"name": st.name, "call": st.call, "index": st.index,
                       "ms": st.ms, "launch": st.launch,
                       **({"ts": where[id(st)][0], "dur": where[id(st)][1]}
                          if id(st) in where else {})}
                      for st in rec.stages],
           "snapshot": snap}
    with open(spans_path, "w") as f:
        json.dump(out, f)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for leaf in x:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def hard_sync(x):
    """Wait until the device has computed ``x`` (a tensor, or a dict, list
    or tuple holding tensors): ``torch.cuda.synchronize`` on the device of
    its first tensor when that is a card; CPU work is done on return."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return x
