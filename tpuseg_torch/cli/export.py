"""``python -m tpuseg_torch.cli.export`` — write a port checkpoint (a trainer
directory, whose latest step is taken, or a ``.pth``) as the mirror-named
``.pth`` state_dict that ``tpuseg.ckpt.torch_import.load_pth_checkpoint``
and the port's ``--checkpoint`` read (port of ``tpuseg/cli/export.py``).

The weights are loaded into the U-Net of the config (``--config`` /
``--set model.*``) first, so a checkpoint of another architecture is
refused rather than written.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    from tpuseg_torch.cli.common import (add_config_args, load_config,
                                         load_model_state)

    add_config_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="trainer checkpoint dir (or .pth to re-export)")
    p.add_argument("--output", required=True, help=".pth file to write")
    args = p.parse_args(argv)
    cfg = load_config(args)

    import torch

    from tpuseg_torch.models import UNet3D

    model = UNet3D(cfg.model)
    model.load_state_dict(load_model_state(args.checkpoint))
    sd = {k: v.detach().float().contiguous()
          for k, v in model.state_dict().items()}
    torch.save(sd, args.output)
    n_params = sum(int(v.numel()) for v in sd.values())
    print(f"{args.checkpoint} -> {args.output}: {len(sd)} tensors, "
          f"{n_params:,} values")


if __name__ == "__main__":
    main()
