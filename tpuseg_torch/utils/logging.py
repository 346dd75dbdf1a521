"""Structured metrics logging (port of ``tpuseg/utils/logging.py``): one
JSONL record per logged step (step, wall time, losses, grad norm, Mvox/s).
The JAX package's optional TensorBoard writer is not ported."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
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
        if self.echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
