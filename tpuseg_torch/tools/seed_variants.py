"""The seed kernels (K1 seed pass, K5 peak NMS) on the card: the tile pass at
other numbers of z chunks and on loads that skip more or less of its work,
beside the chain of whole-volume launches it replaced.

    python3 tpuseg_torch/tools/seed_variants.py

At 96x512x512, radius 2, on two loads — the analytic maps of the
600-instance synthetic stack and the probabilities of the full default U-Net
with seeded weights (the main path's load) — holds every variant against the
plain twin, elementwise, and times it (CUDA events after a warm-up):

* the tile pass with the z axis cut into 1, 2, 3, 4 and 6 chunks (0: the
  kernel's own rule), and the chain;
* the tile pass at thresholds that change what it may skip: above every
  value (both poolings skipped for every plane: staging, rings and barriers
  alone) and below every value (nothing skipped; candidates only on ties);
* K1's walk tail alone (``chase_pass`` of 8 steps), to read K1 without it;
* peak device memory of one call of each body.

Needs ``nvcc`` (``CUDA_HOME`` or /usr/local/cuda) and one GPU; prints a
table and ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from tpuseg_torch.ops.nms import fused_peak_nms, fused_peak_nms_plain  # noqa: E402
from tpuseg_torch.ops.resolve import chase_pass  # noqa: E402
from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain  # noqa: E402
from tpuseg_torch.tools.resolve_variants import cuda_ms, loads  # noqa: E402

RADIUS = (2, 2, 2)
ZCHUNKS = (0, 1, 2, 3, 4, 6)


def peak_mb(fn) -> float:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e6


def main() -> int:
    for load, (fg, pk) in loads().items():
        print(f"{load}, {tuple(pk.shape)}, radius {RADIUS}:")
        for thr, what in ((0.5, "threshold 0.5"),
                          (2.0, "threshold above every value (all skipped)"),
                          (-1.0, "threshold below every value (none skipped)")):
            want5 = fused_peak_nms_plain(pk, thr, RADIUS)
            want1 = seed_chase_pass_plain(pk, fg, thr, 0.5, RADIUS)
            for body, chunks in [("tile", z) for z in ZCHUNKS] + [("chain", 0)]:
                def k5():
                    return fused_peak_nms(pk, thr, RADIUS, body=body,
                                          zchunks=chunks)

                def k1():
                    return seed_chase_pass(pk, fg, thr, 0.5, RADIUS,
                                           body=body, zchunks=chunks)

                if not torch.equal(k5(), want5) or any(
                        not torch.equal(a, b) for a, b in zip(k1(), want1)):
                    raise SystemExit(f"{body} body, {chunks} z chunks, {what}: "
                                     "kernel != twin")
                print(f"  {what:<44} {body:<5} z chunks {chunks}: K5 "
                      f"{cuda_ms(k5, 10):6.3f} ms, K1 {cuda_ms(k1, 10):6.3f} ms")
                if thr != 0.5:
                    break
        dirs, v = seed_chase_pass(pk, fg, 0.5, 0.5, RADIUS)
        fgm = fg >= 0.5
        print(f"  K1's walk tail alone (chase_pass of 8 steps): "
              f"{cuda_ms(lambda: chase_pass(v, dirs, fgm, 8), 10):6.3f} ms")
        for body in ("tile", "chain"):
            print(f"  peak device memory of one call, {body} body: K5 "
                  f"{peak_mb(lambda: fused_peak_nms(pk, 0.5, RADIUS, body=body)):.1f}"
                  f" MB, K1 "
                  f"{peak_mb(lambda: seed_chase_pass(pk, fg, 0.5, 0.5, RADIUS, body=body)):.1f}"
                  f" MB (outputs included)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
