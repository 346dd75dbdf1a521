"""The chase's 128-pass cap: the port stops where the JAX package's Pallas
chase stops (interpret mode), and the flood after it gives equal labels.

A 1 x 1 x 1200 foreground row of constant peak points every voxel at its +x
neighbour (the largest linear index wins a plateau), so the only root is
the last voxel and the chain is 1199 hops long: more than the 128 passes of
8 steps can walk. Long plateau chains are how bf16 probabilities run the
chase into its cap; this holds both packages to the same stopping point."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops.pallas_resolve import chase_resolve as ref_chase_resolve
from tpuseg.ops.pallas_resolve import flood_resolve as ref_flood_resolve
from tpuseg_torch.ops.resolve import (_chase_loop, chase_pass_plain,
                                      flood_resolve_plain)
from tpuseg_torch.ops.watershed import steepest_dir_codes

from test_torch_model import single_torch_thread  # noqa: F401

N = 1200
ITERS, CAP = 8, 128


@pytest.fixture(scope="module")
def row():
    peak = np.full((1, 1, N), 0.7, np.float32)
    fg = np.ones((1, 1, N), bool)
    dirs = steepest_dir_codes(torch.from_numpy(peak),
                              torch.from_numpy(fg)).numpy()
    v0 = np.zeros((1, 1, N), np.int32)
    v0[0, 0, -1] = N                     # the one seed: +(lin + 1)
    return peak, fg, dirs, v0


def test_plateau_row_points_to_its_last_voxel(row):
    _, _, dirs, _ = row
    assert (dirs[0, 0, :-1] == 5).all() and dirs[0, 0, -1] == 0   # +x, self


@pytest.mark.parametrize("max_passes", [CAP, 150])
def test_chase_cap_stops_where_the_reference_stops(row, max_passes):
    peak, fg, dirs, v0 = row
    passes = []

    def counted(*args):
        passes.append(1)
        return chase_pass_plain(*args)

    got = _chase_loop(counted, torch.from_numpy(v0), torch.from_numpy(dirs),
                      torch.from_numpy(fg), ITERS, max_passes).numpy()
    want = np.asarray(ref_chase_resolve(
        jnp.asarray(v0), jnp.asarray(dirs), jnp.asarray(fg),
        iters_per_pass=ITERS, max_passes=max_passes, block=(1, 1),
        interpret=True))
    np.testing.assert_array_equal(got, want)
    # 1199 hops need 150 passes of 8: the cap of 128 leaves the first
    # 1199 - 128 * 8 = 175 voxels at 0
    unresolved = int((got == 0).sum())
    if max_passes == CAP:
        assert len(passes) == CAP and unresolved == N - 1 - CAP * ITERS
    else:
        assert len(passes) == 150 and unresolved == 0

    # the flood after the chase takes what the cap left, in both packages
    flood_iters = 96
    seeds = np.maximum(got, 0)
    got_l = flood_resolve_plain(torch.from_numpy(seeds), torch.from_numpy(fg),
                                torch.from_numpy(peak), flood_iters).numpy()
    want_l = np.asarray(ref_flood_resolve(
        jnp.asarray(seeds), jnp.asarray(fg), jnp.asarray(peak), flood_iters,
        block=(1, 1), interpret=True))
    np.testing.assert_array_equal(got_l, want_l)
    assert int((got_l == 0).sum()) == max(0, unresolved - flood_iters)
