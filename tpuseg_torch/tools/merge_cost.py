"""The saddle merge's cost on the card, for one checkout or for two in turns.

    python3 tpuseg_torch/tools/merge_cost.py [--root DIR]

On the watershed labels of the 96x512x512 synthetic stack under the default
post-processing — the analytic maps (600 nuclei) and the full default U-Net
with seeded weights (thousands of small basins) — times
``ops.merge.saddle_merge`` at ratio 0.8 (host clock to
``torch.cuda.synchronize()``, after a warm-up) and its peak device memory
above its inputs (``torch.cuda.max_memory_allocated``), and prints one JSON
line with the times, the peak, a checksum of the merged labels and the
card's name and power limit. ``--root`` imports ``tpuseg_torch`` from another checkout (an
unpacked ``git archive`` of another commit): run it in turns with and
without, each in its own process, to compare two versions of the merge on
the same card; equal checksums mean equal labels (to the sum's resolution).

Needs ``nvcc`` (``CUDA_HOME`` or /usr/local/cuda) and one GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

RATIO = 0.8
REPS = 5


def wall_ms(fn, reps: int) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round(1e3 * (time.perf_counter() - t0), 3))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(
        Path(__file__).resolve().parent.parent.parent),
        help="the checkout whose tpuseg_torch to time (default: this one)")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import tpuseg_torch
    from tpuseg_torch.core import Config
    from tpuseg_torch.ops import watershed
    from tpuseg_torch.ops.merge import saddle_merge
    from tpuseg_torch.tools.resolve_variants import loads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rec = {"root": str(Path(tpuseg_torch.__file__).resolve().parent.parent),
           "card": smi, "ratio": RATIO}
    pp = Config().postproc
    for load, (fg, pk) in loads().items():
        labels = watershed(fg, pk, peak_threshold=pp.peak_threshold,
                           fg_threshold=pp.fg_threshold,
                           peak_radius=pp.nms_radius)
        merged = saddle_merge(labels, pk, RATIO, pp.merge_max_pairs)
        del merged
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        merged = saddle_merge(labels, pk, RATIO, pp.merge_max_pairs)
        torch.cuda.synchronize()
        rec[load] = {
            "peak_mib_above_inputs": round(
                (torch.cuda.max_memory_allocated() - base) / 2 ** 20, 1),
            "saddle_merge_ms": wall_ms(lambda: saddle_merge(
                labels, pk, RATIO, pp.merge_max_pairs), REPS),
            "labels_before": int(torch.unique(labels).numel()),
            "labels_after": int(torch.unique(merged).numel()),
            "checksum": int(merged.long().sum())}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
