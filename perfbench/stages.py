"""The program's device stages of an inference cell's call, one graph
against two: the configuration's call (``infer.program="fused"``) and the
staged call that the traced run times (``"staged"``), each under a
``torch.profiler`` session, on the cell's traffic and trained weights.

    python3 perfbench/stages.py --workload infer-stack600 --seed <n> \\
        [--stacks 12]

From the root of a checkout, on a card. For each program: three calls
(eager, capture, replay), then ``--stacks`` timed calls with no session
and ``--stacks`` under a session (host milliseconds a stack, each call to
its ``synchronize()``), and the stages the program recorded in the session
(``tpuseg_torch.utils.profiling.snapshot()``: device milliseconds per
call, summed per stack, and the host's ``program.prep``). A program
without that recorder reports the times alone. The last stdout line is
JSON: per program ``untraced_ms``, ``traced_ms`` (means a stack),
``stages`` and ``prep_ms``; and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _timed(infer, stacks, n, sync) -> list:
    out = []
    for i in range(n):
        a = time.perf_counter()
        infer(stacks[i % len(stacks)].image)
        sync()
        out.append(1e3 * (time.perf_counter() - a))
    return out


def measure(cell, seed: int, program: str, n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import infer_cell, program as prog_record

    stacks, _, _, model, infer = infer_cell.build(
        cell, seed, "cuda", **{"infer.program": program})
    for i in range(3):
        infer(stacks[i % len(stacks)].image)
    torch.cuda.synchronize()
    untraced = _timed(infer, stacks, n, torch.cuda.synchronize)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = _timed(infer, stacks, n, torch.cuda.synchronize)
    snap = prog_record.snapshot()
    out = {"untraced_ms": statistics.mean(untraced),
           "traced_ms": statistics.mean(traced)}
    if snap is not None:
        out["stages"] = {k: v.get("sum_ms", 0) / n
                         for k, v in snap["stages"].items()}
        prep = snap["spans"].get("program.prep")
        out["prep_ms"] = prep["sum_ms"] / n if prep else None
        out["missed"] = snap["counters"].get("stages.missed", {}).get(
            "count", 0)
        from tpuseg_torch.utils import profiling

        profiling.reset()
    infer.release()
    del infer, model, stacks
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench import cells

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--stacks", type=int, default=12)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if cell.config["kind"] != "infer":
        print(f"{args.workload} is not an inference cell", file=sys.stderr)
        return 2
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cells.CACHE / "torch_extensions")
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = {p: measure(cell, args.seed, p, args.stacks)
           for p in ("fused", "staged")}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
