"""Structured metrics logging (port of ``tpuseg/utils/logging.py``): one
JSONL record per logged step (step, wall time, losses, grad norm, Mvox/s),
and optionally the same scalars as TensorBoard events
(``torch.utils.tensorboard``; without the tensorboard package the writer is
off, as in the JAX package)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir:
            try:  # optional: an opt-in dependency
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                self._tb = None
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: Dict[str, float], **extra) -> None:
        rec = {
            "step": int(step),
            "wall_s": round(time.perf_counter() - self._t0, 3),
            **{k: float(v) for k, v in metrics.items()},
            **extra,
        }
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self._tb is not None:
            for k, val in metrics.items():
                self._tb.add_scalar(k, float(val), int(step))
        if self.echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
