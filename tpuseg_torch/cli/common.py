"""Shared CLI plumbing: config loading + dotted overrides (the same flags and
JSON format as ``tpuseg/cli/common.py``), the checkpoint-in contract and the
runtime bootstrap."""

from __future__ import annotations

import argparse
import json

from tpuseg_torch.core import Config


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None,
                   help="JSON config file (defaults used if omitted)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set postproc.min_size=50 "
                        "--set infer.tile=[32,128,128] (repeatable)")


def load_config(args) -> Config:
    cfg = Config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    if args.overrides:
        kv = {}
        for item in args.overrides:
            key, _, val = item.partition("=")
            if not _:
                raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
            try:
                kv[key] = json.loads(val)
            except json.JSONDecodeError:
                kv[key] = val  # bare string
        cfg = cfg.override(**kv)
    return cfg


def load_model_state(ckpt: str):
    """Checkpoint-in contract: a mirror-named ``.pth`` (``tpuseg.cli.export``
    or a trainer step's ``model.pth``), or a trainer checkpoint directory
    (``train.ckpt_dir``: its latest step), as a port ``state_dict``."""
    import os

    from tpuseg_torch.ckpt import CheckpointManager, load_pth

    if os.path.isdir(ckpt):
        ckpt = CheckpointManager(ckpt).model_path()
    return load_pth(ckpt)


def bootstrap_runtime(device: str = "cuda") -> None:
    """Process-level runtime set-up for every CLI entry point: the
    multi-process group when the ``TPUSEG_COORDINATOR`` /
    ``TPUSEG_NUM_PROCESSES`` / ``TPUSEG_PROCESS_ID`` (and optionally
    ``TPUSEG_DIST_BACKEND``) environment is present
    (``parallel/multihost.initialize``; a no-op without it), with one line
    per process saying where it runs."""
    from tpuseg_torch.parallel.multihost import (backend, initialize,
                                                 is_distributed,
                                                 process_count,
                                                 process_device,
                                                 process_index)

    initialize(device=device)
    if is_distributed():
        print(f"process {process_index()}/{process_count()} on "
              f"{process_device(device)}, backend {backend()}", flush=True)
