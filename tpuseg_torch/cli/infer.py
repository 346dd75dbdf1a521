"""``python -m tpuseg_torch.cli.infer`` — whole-volume instance segmentation
on one device (port of ``tpuseg/cli/infer.py``, single-device branch):
checkpoint in, instance-label volume out. Exit status 4 when
``--report-convergence`` finds the flood truncated.
"""

from __future__ import annotations

import argparse
import time

# flags of tpuseg.cli.infer that the port does not take yet (ROADMAP.md)
_UNPORTED = ("--calibrate-from", "--stream", "--resume-dir", "--stream-shard",
             "--validate", "--shard")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    from tpuseg_torch.cli.common import add_config_args, load_config

    add_config_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="mirror-named .pth state_dict (tpuseg.cli.export)")
    p.add_argument("--input", required=True, help="volume file (npy/npz)")
    p.add_argument("--output", required=True,
                   help="instance-label volume out (npy/npz, int32)")
    p.add_argument("--no-normalize", action="store_true",
                   help="skip percentile normalization (input already in [0,1])")
    p.add_argument("--report-convergence", action="store_true",
                   help="report the watershed flood-truncation count; "
                        "nonzero exits with status 4")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    for flag in _UNPORTED:
        p.add_argument(flag, nargs="?", const=True, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag in _UNPORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            p.error(f"{flag} is not ported yet (see ROADMAP.md)")
    cfg = load_config(args)

    import numpy as np
    import torch

    from tpuseg_torch.ckpt import load_pth
    from tpuseg_torch.data.volume_io import load_volume, save_volume
    from tpuseg_torch.infer import make_infer_fn
    from tpuseg_torch.models import build_model

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    model = build_model(cfg.model)
    model.load_state_dict(load_pth(args.checkpoint))
    model.to(device)
    volume = load_volume(args.input).astype(np.float32)

    t0 = time.perf_counter()
    infer = make_infer_fn(model, cfg, normalize=not args.no_normalize,
                          with_diagnostics=args.report_convergence)
    out = infer(torch.from_numpy(volume).to(device))
    labels, diag = out if args.report_convergence else (out, None)
    labels = labels.cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0

    status = 0
    if diag is not None:
        n_trunc = diag["flood_truncated"]
        print(f"flood convergence: TRUNCATED ({n_trunc} truncated voxels — "
              "raise postproc.flood_iters)" if n_trunc else
              "flood convergence: CONVERGED (0 truncated voxels)")
        status = 4 if n_trunc else 0

    save_volume(args.output, labels)
    n = int(labels.max())
    mvox = volume.size / 1e6
    print(f"{args.input}: {volume.shape} -> {n} instances on {device} "
          f"in {dt:.2f}s ({mvox / dt:.2f} Mvox/s) -> {args.output}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
