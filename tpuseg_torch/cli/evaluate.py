"""``python -m tpuseg_torch.cli.evaluate`` — instance-level metrics between a
predicted and a ground-truth label volume (port of
``tpuseg/cli/evaluate.py``: the same flags and the same JSON)."""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred", required=True, help="predicted label volume")
    p.add_argument("--gt", required=True, help="ground-truth label volume")
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--criterion", choices=("iou", "center"), default="iou")
    args = p.parse_args(argv)

    from tpuseg_torch.data.volume_io import load_volume
    from tpuseg_torch.eval import instance_metrics, voxel_metrics

    pred = load_volume(args.pred)
    gt = load_volume(args.gt)
    m = instance_metrics(pred, gt, iou_threshold=args.iou_threshold,
                         criterion=args.criterion)
    m.update(voxel_metrics(pred, gt))
    print(json.dumps(m, indent=2))


if __name__ == "__main__":
    main()
