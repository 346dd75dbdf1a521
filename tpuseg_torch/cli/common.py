"""Shared CLI plumbing: config loading + dotted overrides (the same flags and
JSON format as ``tpuseg/cli/common.py``)."""

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
