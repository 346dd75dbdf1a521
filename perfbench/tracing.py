"""The traced window: ``torch.profiler`` over a run's timed loop, reduced to
what the per-layer metrics and the breakdown read.

The profiler's Chrome trace is read back as two lists of ``(name, start
us, duration us)``: the device's operations (kernels, copies, fills) and
the host's (torch ops, CUDA runtime calls, and the benchmark's own spans,
which it records with ``record_function``). The window is the span
:data:`WINDOW` around the loop. Busy time is the union of the device
operations inside it; an idle gap is a stretch of the window with none,
named by the innermost benchmark span and the innermost host call running
at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def traced(path: str):
    """Profile the block (the host's ops and the device's) and write the
    Chrome trace to ``path``; the block runs its loop inside
    ``span(WINDOW)``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def span(name: str):
    """A benchmark span in the trace (a no-op outside a profile)."""
    return torch.profiler.record_function(name)


class Trace:
    """A Chrome trace reduced to the window's device and host operations."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"{path}: no {WINDOW} span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])

        def inside(e):
            ts = float(e["ts"])
            return ts < self.t1 and ts + float(e.get("dur", 0)) > self.t0

        def ops(cats):
            return sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0)))
                           for e in spans if e.get("cat") in cats
                           and inside(e)), key=lambda op: op[1])

        self.device = ops(DEVICE_CATS)
        self.host = ops(HOST_CATS)
        self.spans = ops(("user_annotation",))
        self._busy = self._merge()

    def _merge(self) -> list:
        out = []
        for _, ts, dur in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e6

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the operations whose names contain one of
        ``patterns``."""
        return sum(dur for name, _, dur in self.device
                   if any(p in name for p in patterns)) / 1e6

    def gaps(self) -> list:
        """``(start us, end us)`` of each idle stretch of the window."""
        edges = [self.t0] + [v for ab in self._busy for v in ab] + [self.t1]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def _label(self, t: float) -> str:
        def innermost(ops, starts):
            hits = []
            for i in range(bisect.bisect_right(starts, t) - 1,
                           max(-1, bisect.bisect_right(starts, t) - 4000),
                           -1):
                name, ts, dur = ops[i]
                if ts + dur >= t and name != WINDOW:
                    hits.append((dur, name))
            return min(hits)[1] if hits else None

        parts = [innermost(self.spans, self._span_starts),
                 innermost(self.host, self._host_starts)]
        return " / ".join(p for p in parts if p) or "no host op"

    def breakdown(self, top: int = 10, labelled: int = 200) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the ``labelled`` longest gaps; the rest
        summed as "shorter gaps"), in seconds."""
        self._span_starts = [ts for _, ts, _ in self.spans]
        self._host_starts = [ts for _, ts, _ in self.host]
        ops = defaultdict(float)
        for name, _, dur in self.device:
            ops[name[:160]] += dur / 1e6
        idle = defaultdict(float)
        gaps = sorted(self.gaps(), key=lambda ab: ab[0] - ab[1])
        for i, (a, b) in enumerate(gaps):
            label = (self._label((a + b) / 2) if i < labelled
                     else "shorter gaps")
            idle[label] += (b - a) / 1e6

        def first(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": first(ops), "idle_gaps": first(idle)}
