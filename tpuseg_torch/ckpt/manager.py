"""Trainer checkpoints on ``torch.save`` (the counterpart of
``tpuseg/ckpt/orbax_io.py``, with its contract: ``save(step, params,
opt_state, meta, batch_stats)``, ``latest_step``, ``restore``, ``keep=N``).

Each step is a directory ``<dir>/<step>/`` holding

  state.pt    params, opt_state and batch_stats (``torch.save``)
  meta.json   step, sampler state, config, best validation loss, ...
  model.pth   the mirror-named model ``state_dict`` (params and running
              statistics), which ``tpuseg_torch.cli.infer --checkpoint``
              and ``ckpt.load_pth`` read as it is

written to a temporary directory first and renamed into place, so a step
directory is either complete or absent. Saves are synchronous.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

MODEL_FILE = "model.pth"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.isdir(os.path.join(self.directory, d)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, params: Any, opt_state: Any, meta: dict,
             batch_stats: Any = None) -> None:
        final = self.step_dir(step)
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        params, batch_stats = _cpu(params), _cpu(batch_stats or {})
        torch.save({"params": params, "opt_state": _cpu(opt_state),
                    "batch_stats": batch_stats},
                   os.path.join(tmp, "state.pt"))
        torch.save({**params, **batch_stats}, os.path.join(tmp, MODEL_FILE))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None):
        """``(params, opt_state, meta, batch_stats)`` at ``step`` (default:
        the latest), tensors on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self.step_dir(step)
        state = torch.load(os.path.join(d, "state.pt"), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return (state["params"], state["opt_state"], meta,
                state["batch_stats"] or None)

    def model_path(self, step: Optional[int] = None) -> str:
        """The mirror-named ``.pth`` of ``step`` (default: the latest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return os.path.join(self.step_dir(step), MODEL_FILE)
