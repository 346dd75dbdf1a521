"""Tiny cells of the benchmark's two kinds, for CPU runs of the harness:
the configurations' structure and widths, shapes a CPU test can hold.

bf16's rounding averages out less over a tiny cell's few voxels, so its
check limits are the tiny size's own (set from CPU readings of sound runs:
train loss 0.0007-0.003, gradient 0.05-0.14, parameter change 0.05-0.08;
inference probability gaps 0.002 at most, 0.0007 on average), well under
what the faults read (``test_pb_faults.py``)."""

from __future__ import annotations

import copy

from perfbench import cells, gen

#: a tiny mix's volumes by generator: the nuclei's stacks, and one
#: touching pair beside one single nucleus
SMALL = {"nuclei": {"shape": [8, 40, 32], "count": 2, "nuclei": 3,
                    "radius_range": [2.0, 3.0],
                    "anisotropy": [0.6, 1.0, 1.0], "noise": 0.05,
                    "min_center_dist": 5.0},
         "touching": {"generator": "touching", "shape": [8, 40, 32],
                      "count": 2, "pairs": 1, "singles": 1,
                      "touch_range": [0.5, 0.7], "radius_range": [2.0, 3.0],
                      "anisotropy": [0.6, 1.0, 1.0], "noise": [0.05, 0.12],
                      "min_center_dist": 8.0}}


def tiny_cell(name: str) -> cells.Cell:
    """``name``'s cell, its stacks (by its mix's generator), tiles,
    patches, weights recipe and traced units cut to a CPU test's size."""
    cell = cells.load_cell(name)
    c = copy.deepcopy(cell.config)
    t = copy.deepcopy(cell.traffic)
    spec = copy.deepcopy(cell.spec)
    small = SMALL["nuclei"]
    if c["kind"] == "infer":
        t["volumes"] = copy.deepcopy(SMALL[gen.generator(t["volumes"])])
        c["settings"].update({"infer.tile": [8, 16, 32],
                              "infer.halo": [0, 4, 0]})
        c["weights"].update(steps=2, volumes=dict(small, count=1))
        c["weights"]["data"].update(patch_size=[8, 16, 16], batch_size=2)
        c["name"] = "tiny-" + c["name"]
        spec["trace_units"] = 2
        spec["check"]["limits"].update(prob_gap_max=0.006,
                                       prob_gap_mean=0.0015)
    else:
        t["volumes"] = dict(small, shape=[16, 24, 24])
        c["settings"].update({"data.batch_size": 2,
                              "data.patch_size": [8, 16, 16],
                              "train.log_every": 2})
        spec["trace_units"] = 2
        spec["check"]["limits"] = {"loss_gap": 0.01, "grad_gap": 0.3,
                                   "param_change_gap": 0.3,
                                   "bn_stats_gap": 0.02}
    return cells.Cell(cell.name, cell.entry, spec, c, t, cell.end_to_end,
                      cell.per_layer)
