"""The readings the output checks' limits are set from, at a cell's own
size: the program's sound runs over many seeds (the lower reading) and the
control's (the upper), in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3]

Each program seed is a whole run of the cell (set-up, a short window, the
check), its compared numbers printed as one JSON line. The control is the
reference itself put in the program's place, rounded to fp8 (the precision
below the configuration's bf16, ``reference/quant.py``), read on the same
numbers. A training cell also reads the fault "half of the batch left out,
the mean taken over the rest" (the reference stepping on the first half of
each batch). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def infer_control(cell, seed: int, device="cuda") -> dict:
    from perfbench import gen, infer_cell, weights
    from perfbench.reference.quant import fp8

    stacks = gen.volumes_for(cell.traffic["volumes"], seed, device)
    state = weights.trained_state(cell.config, device)
    inputs = [(v, None, None) for v in stacks[:cell.spec["check"].get(
        "samples", 1)]]
    return infer_cell.readings(cell, state, stacks[0], inputs, quant=fp8)


def train_control(cell, seed: int, device="cuda") -> dict:
    """The fp8 control's readings and the half-batch fault's."""
    import numpy as np
    from tpuseg_torch.data.sampler import PatchSampler

    from perfbench import cells, gen, train_cell
    from perfbench.reference.quant import fp8

    vols = [gen.Volume(v.image.cpu().numpy(), v.centers, v.half_sizes)
            for v in gen.volumes_for(cell.traffic["volumes"], seed, device)]
    s = cell.config["settings"]
    sampler = PatchSampler(vols, patch_size=s["data.patch_size"],
                           batch_size=s["data.batch_size"],
                           max_instances=s["data.max_instances"],
                           seed=gen.sub_seed(seed, 5))
    batches = [sampler.next_batch() for _ in range(train_cell.CHECKED)]
    arch = cells.load_arch(cells.arch_name(cell.config))
    state0 = arch.init_state(cell.config["model"], gen.sub_seed(seed, 3),
                             device)
    step_seed = gen.sub_seed(seed, 6)
    want = train_cell.reference_run(cell, state0, batches, step_seed, device)
    out = {}
    ctl = train_cell.reference_run(cell, state0, batches, step_seed, device,
                                   quant=fp8)
    out["control"] = train_cell.compare(state0, ctl, want)
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    fault = train_cell.reference_run(cell, state0, half, step_seed, device)
    out["half_batch"] = train_cell.compare(state0, fault, want)
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench import cells, infer_cell, train_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    kind = cell.config["kind"]
    driver = {"infer": infer_cell, "train": train_cell}[kind]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        res = driver.run(cell, seed, args.seconds, False, time.perf_counter())
        print(json.dumps({"seed": seed, "side": "program",
                          "correct": res.correct,
                          "readings": {k: v for k, v, _ in res.checks}}),
              flush=True)
    control = {"infer": infer_control, "train": train_control}[kind]
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        print(json.dumps({"seed": seed, "side": "control",
                          "readings": control(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
