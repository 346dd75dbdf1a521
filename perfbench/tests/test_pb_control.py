"""The controls fail the checks: each cell's reference, put in the
program's place and rounded to fp8, on three seeds at the cell's own size
(on the card; ``control.py`` reads the same for the limits). The training
cell's half-batch fault too."""

import pytest

from perfbench import cells, control

SEEDS = (3200000001, 3200000002, 3200000003)


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_controls_fail_at_the_cells_size(name, card):
    cell = cells.load_cell(name)
    limits = cell.spec["check"]["limits"]
    for seed in SEEDS:
        if cell.config["kind"] == "infer":
            assert _fails(control.infer_control(cell, seed, card), limits)
        else:
            got = control.train_control(cell, seed, card)
            assert _fails(got["control"], limits)
            assert _fails(got["half_batch"], limits)
