"""Profiling hooks (port of ``tpuseg/utils/profiling.py``).

``trace`` records a ``torch.profiler`` session (host and, with a card,
device activity) and writes it as a Chrome trace; ``Timer`` is a
median-of-k wall timer that synchronizes on the result. Once the profiler
has traced, later launches of the process cost the host more (measured on
an H100: the train step read 20-30% slower afterwards), so trace last.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the ``with`` body into ``<log_dir>/trace.json`` (Chrome /
    Perfetto format); a no-op for ``None``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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


class Timer:
    """Median-of-k wall timer with device synchronization."""

    def __init__(self, sync=hard_sync):
        self.sync = sync

    def time(self, fn, *args, iters: int = 5, warmup: int = 2, **kw) -> float:
        for _ in range(warmup):
            self.sync(fn(*args, **kw))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.sync(fn(*args, **kw))
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]
