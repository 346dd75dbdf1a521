"""``python -m tpuseg_torch.cli.train`` — weakly-supervised training (port of
``tpuseg/cli/train.py``): on one device, or data-parallel over N processes
started with the ``TPUSEG_*`` environment (``cli/common.bootstrap_runtime``;
one process per card, or gloo processes on the CPU), rank 0 writing the
checkpoints, the config and the log.

Volumes come either from --image/--annotations file pairs (npy/npz; see
``data/volume_io.py``) or --synthetic for the built-in fixture. Checkpoints
go to ``train.ckpt_dir``; ``tpuseg_torch.cli.infer --checkpoint`` takes that
directory (or a step's ``model.pth``) as it is.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    from tpuseg_torch.cli.common import add_config_args, load_config

    add_config_args(p)
    p.add_argument("--image", action="append", default=[],
                   help="volume file (npy/npz); repeatable")
    p.add_argument("--annotations", action="append", default=[],
                   help="weak-annotation npz (centers, half_sizes); one per --image")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic volumes instead of files")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log", default=None, help="metrics JSONL path")
    p.add_argument("--val-fraction", type=float, default=None,
                   help="hold out this fraction for validation (whole volumes "
                        "when several are given, a z-slab of a single one); "
                        "logs val_* metrics and keeps the best checkpoint "
                        "under <ckpt_dir>/best")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    from tpuseg_torch.cli.common import bootstrap_runtime

    bootstrap_runtime(args.device)
    cfg = load_config(args)
    if args.val_fraction is not None:
        cfg = cfg.override(**{"train.val_fraction": args.val_fraction})

    import numpy as np

    from tpuseg_torch.data import (SyntheticVolume, load_annotations,
                                   load_volume, synthesize_volume)
    from tpuseg_torch.parallel.multihost import process_index
    from tpuseg_torch.train import train

    if args.synthetic:
        volumes = [
            synthesize_volume(shape=(64, 128, 128), num_instances=16, seed=s)
            for s in range(args.synthetic)
        ]
    else:
        if not args.image or len(args.image) != len(args.annotations):
            p.error("need matching --image/--annotations pairs (or --synthetic N)")
        volumes = []
        for img_path, ann_path in zip(args.image, args.annotations):
            img = load_volume(img_path).astype(np.float32)
            centers, halfs = load_annotations(ann_path)
            volumes.append(
                SyntheticVolume(image=img, labels=np.zeros_like(img, np.int32),
                                centers=centers, half_sizes=halfs))

    if process_index() == 0:
        os.makedirs(cfg.train.ckpt_dir, exist_ok=True)
        with open(os.path.join(cfg.train.ckpt_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    _, history = train(cfg, volumes, log_path=args.log, resume=args.resume,
                       device=args.device)
    if history and process_index() == 0:
        h = [h for h in history if "loss" in h][-1]
        print(f"done: step {h['step']} loss {h['loss']:.4f} "
              f"({h['mvox_per_s']:.2f} Mvox/s)")


if __name__ == "__main__":
    main()
