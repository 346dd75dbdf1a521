"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Set-up (traffic from the seed, weights,
warm-up: everything before the first timed call, from process start) is
``setup_s``; then the window measures for ``--seconds`` (``--trace 0``:
the cell's end-to-end metrics) or runs the cell's ``trace_units`` under
``torch.profiler`` (``--trace 1``: its per-layer metrics, the device's busy
time and a breakdown). Then the output check against the plain reference.
The last stdout line is the result as JSON; the numbers compared, each
beside its limit, are the last stderr lines and the line's last key.

Exits 2 without a result when no card is there, or fewer than the cell
asks for; 3 when the process holds JAX or the JAX package after the window.
Build and kernel caches stay inside the checkout (``perfbench/.cache``,
``tpuseg_torch/_build``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench import cells

    t_start = cells.T0 = T_START - cells.process_age()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cells.CACHE / sub)

    import torch

    cells.phase("import")
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    from perfbench import infer_cell, train_cell

    driver = {"infer": infer_cell, "train": train_cell}[cell.config["kind"]]
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        t_start)
    bad = cells.forbidden_modules()
    if bad:
        print(f"the run's process holds {bad}", file=sys.stderr)
        return 3
    cells.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
