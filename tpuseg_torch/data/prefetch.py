"""Background input prefetch for the training loop (port of
``tpuseg/data/prefetch.py``).

A worker thread samples batches and uploads them (``put``: pinned host
memory, ``non_blocking`` copies) into a small queue, so host sampling and
the host-to-device copy of batch N+1 overlap step N. Batches are pure
functions of (seed, step), and ``state_dict()`` reports the CONSUMED step
count — not how far the worker has run ahead — so kill-and-resume replays
exactly the batches that were never consumed.

Under a ``torch.profiler`` session (``utils/profiling.py``) the worker
records ``feed.sample`` and ``feed.put`` spans, and the consumer a
``feed.next`` span with the queue's depth as it found it (the
``feed.depth`` counter: 0 means the step waited for a batch).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from tpuseg_torch.utils import profiling
from tpuseg_torch.utils.profiling import span


class BatchPrefetcher:
    """Wraps a PatchSampler with a depth-``depth`` background pipeline;
    ``put`` maps a host batch to a device batch on the worker thread."""

    def __init__(self, sampler, put: Optional[Callable] = None, depth: int = 2):
        self.sampler = sampler
        self.put = put or (lambda b: b)
        self.consumed_step = sampler.step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                with span("feed.sample"):
                    batch = self.sampler.next_batch()
                with span("feed.put"):
                    batch = self.put(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced on the consumer side
            self._err = e

    def next(self):
        with span("feed.next"):
            if profiling.enabled():
                profiling.count("feed.depth", self._q.qsize())
            return self._next()

    def _next(self):
        while True:
            if self._err is not None:
                raise RuntimeError("prefetch worker failed") from self._err
            try:
                batch = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._err is None:
                    raise RuntimeError("prefetch worker exited unexpectedly")
        self.consumed_step += 1
        return batch

    # -- checkpointable state (mirrors PatchSampler) --------------------------
    def state_dict(self) -> dict:
        return {"seed": self.sampler.seed, "step": self.consumed_step}

    def close(self):
        self._stop.set()
        # drain so a blocked put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
