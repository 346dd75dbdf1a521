"""The plain twins of the port's watershed kernels (K1 seed, K2 chase, K3
flood; ``tpuseg_torch/ops/{seed,resolve}.py``) == the JAX package's Pallas
kernels in interpret mode, elementwise — the same contract the CUDA kernels
are held to against the twins on the card (``chip_smoke.py``).

All outputs are integers computed from identical float32 inputs, so every
comparison is exact (no tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpuseg.ops.neighbors import NEIGHBORS_6, linear_index, shift
from tpuseg.ops.pallas_resolve import chase_pass as ref_chase_pass
from tpuseg.ops.pallas_resolve import chase_resolve as ref_chase_resolve
from tpuseg.ops.pallas_resolve import flood_resolve as ref_flood_resolve
from tpuseg.ops.pallas_seed import seed_chase_pass as ref_seed_chase_pass
from tpuseg.ops.peaks import peak_nms as ref_peak_nms
from tpuseg.ops.watershed import flood_labels as ref_flood_labels
from tpuseg.ops.watershed import steepest_dir_codes as ref_dir_codes
from tpuseg_torch.ops.resolve import (chase_pass, chase_resolve,
                                      chase_resolve_plain, flood_resolve,
                                      flood_resolve_plain)
from tpuseg_torch.ops.nms_cases import (CHAIN_RADII, SMALL_SHAPE, THRESHOLD,
                                        TILE_RADII, adversarial_maps)
from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

from test_torch_model import single_torch_thread  # noqa: F401

SHAPE = (16, 32, 128)


def _peak_fg(shape=SHAPE, seed=0):
    """Noisy gaussian peaks and a foreground map (tests/unit/test_pallas_seed)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    peak = np.zeros(shape, np.float32)
    for _ in range(8):
        c = rng.uniform([2, 2, 2], np.array(shape) - 2)
        s = rng.uniform(1.5, 3.0)
        peak = np.maximum(peak, np.exp(
            -((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
            / (2 * s * s)).astype(np.float32))
    peak += rng.normal(0, 0.02, shape).astype(np.float32)
    fgp = np.clip(peak * 1.4 + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return peak, fgp


def _blob_maps(seed=0, shape=SHAPE):
    """Smooth blob fg/peak maps (tests/unit/test_pallas_resolve)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij")
    peak = np.zeros(shape, np.float32)
    fg = np.zeros(shape, np.float32)
    for _ in range(6):
        c = [rng.uniform(4, s - 4) for s in shape]
        r = rng.uniform(3.0, 5.0)
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        peak = np.maximum(peak, np.exp(-0.5 * d2 / 2.0**2))
        fg = np.maximum(fg, 1 / (1 + np.exp(np.minimum((d2 / r**2 - 1) * 8, 60))))
    return fg.astype(np.float32), peak.astype(np.float32)


def _ref_v0(peak, fgp, pthr, fthr, radius):
    """The unfused XLA composition of the seed pass before its chase steps."""
    peak, fgp = jnp.asarray(peak), jnp.asarray(fgp)
    fg = fgp >= fthr
    seeds = ref_peak_nms(peak, pthr, radius) & fg
    dirs = ref_dir_codes(peak, fg, self_sticky=seeds)
    idx = linear_index(peak.shape)
    v0 = jnp.where(fg & (dirs == 0),
                   jnp.where(seeds, idx + 1, -(idx + 1)), 0).astype(jnp.int32)
    return dirs, v0


def _ref_chase_steps(v, dirs, iters):
    """Lockstep chase steps in plain jnp (any shape, unlike chase_pass)."""
    for _ in range(iters):
        out = v
        for c, (axis, off) in enumerate(NEIGHBORS_6):
            out = jnp.where(dirs == c + 1, shift(v, axis, off, jnp.int32(0)), out)
        v = out
    return v


def _t(a):
    return torch.from_numpy(np.array(a))      # writable copy


# ---------------------------------------------------------------- K1 seed


@pytest.mark.parametrize("radius", [(2, 2, 2), (1, 2, 2), (0, 2, 2)])
def test_seed_twin_matches_pallas(radius):
    peak, fgp = _peak_fg()
    pthr, fthr = 0.4, 0.35
    dirs_r, v_r = ref_seed_chase_pass(jnp.asarray(peak), jnp.asarray(fgp),
                                      pthr, fthr, radius, h0=8, block=(8, 16),
                                      interpret=True)
    dirs, v = seed_chase_pass(_t(peak), _t(fgp), pthr, fthr, radius, h0=8)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_r))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_r))


def test_seed_twin_plateau_matches_pallas():
    """Flat plateaus: every NMS and ascent decision falls to the linear-index
    tie-break (tests/unit/test_pallas_seed zero-radius ramp, plus a flat
    peak plateau on half the volume)."""
    zz = np.arange(SHAPE[0], dtype=np.float32)[:, None, None]
    peak = np.broadcast_to(zz * 0.01, SHAPE).copy()
    peak[:, :16, :64] = 0.95                      # one flat plateau
    fgp = np.ones(SHAPE, np.float32)
    fgp[:, 20:, 100:] = 0.0
    radius = (0, 2, 2)
    dirs_r, v_r = ref_seed_chase_pass(jnp.asarray(peak), jnp.asarray(fgp),
                                      0.9, 0.5, radius, h0=8, block=(8, 16),
                                      interpret=True)
    dirs, v = seed_chase_pass(_t(peak), _t(fgp), 0.9, 0.5, radius, h0=8)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_r))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_r))


@pytest.mark.parametrize("h0", [8, 3])
def test_seed_twin_ragged_shape_matches_xla(h0):
    """A shape no Pallas block takes (the port's kernels take every shape):
    against the unfused XLA composition."""
    shape = (13, 37, 100)
    peak, fgp = _peak_fg(shape, seed=5)
    dirs_r, v0 = _ref_v0(peak, fgp, 0.4, 0.35, (2, 2, 2))
    v_r = _ref_chase_steps(v0, dirs_r, h0)
    dirs, v = seed_chase_pass(_t(peak), _t(fgp), 0.4, 0.35, 2, h0=h0)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_r))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_r))


@pytest.mark.parametrize("radius", TILE_RADII + CHAIN_RADII)
@pytest.mark.parametrize("shape", [(6, 70, 140), SMALL_SHAPE])
def test_seed_twin_adversarial_maps_match_xla(shape, radius):
    """The inputs a tiled seed pass can get wrong (the CUDA kernel's tile is
    (32, 32) in (y, x)): a constant map, plateaus across every tile edge
    with the foreground cutting through them, values at the threshold;
    mixed per-axis radii with 0 and 3-4, rz >= D at the small shape, radii
    above the tile pass's limit. dirs and v both, against the unfused XLA
    composition (no Pallas block takes these shapes)."""
    for name, peak, fgp in adversarial_maps(shape, seed=6):
        dirs_r, v0 = _ref_v0(peak, fgp, THRESHOLD, 0.5, radius)
        v_r = _ref_chase_steps(v0, dirs_r, 8)
        dirs, v = seed_chase_pass(_t(peak), _t(fgp), THRESHOLD, 0.5, radius)
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_r), name)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_r), name)
        if name == "constant" and min(radius) > 0:
            # one seed, at the largest linear index: the only positive root
            assert (np.asarray(v0) > 0).sum() == 1
            assert np.asarray(v0).flat[-1] == v0.size


@pytest.mark.parametrize("radius", [(2, 2, 2), (0, 2, 1)])
def test_seed_twin_adversarial_maps_match_pallas(radius):
    """The same maps through the TPU kernel in interpret mode, at a shape its
    blocks divide."""
    shape = (16, 32, 128)
    for name, peak, fgp in adversarial_maps(shape, seed=7):
        dirs_r, v_r = ref_seed_chase_pass(
            jnp.asarray(peak), jnp.asarray(fgp), THRESHOLD, 0.5, radius, h0=8,
            block=(8, 16), interpret=True)
        dirs, v = seed_chase_pass(_t(peak), _t(fgp), THRESHOLD, 0.5, radius)
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_r), name)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_r), name)


def test_seed_wrapper_takes_twin_on_cpu():
    peak, fgp = _peak_fg(seed=1)
    a = seed_chase_pass(_t(peak), _t(fgp), 0.4, 0.35)
    b = seed_chase_pass_plain(_t(peak), _t(fgp), 0.4, 0.35)
    assert seed_chase_pass.launches == 0           # no kernel on the CPU
    assert seed_chase_pass.tile_launches == 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- K2 chase


def _chase_inputs(seed):
    fg_prob, peak = _blob_maps(seed)
    dirs, v0 = _ref_v0(peak, fg_prob, 0.5, 0.5, 2)
    return fg_prob >= 0.5, dirs, v0


@pytest.mark.parametrize("iters", [8, 5])
def test_chase_pass_twin_matches_pallas(iters):
    fg, dirs, v0 = _chase_inputs(0)
    want = ref_chase_pass(v0, dirs, iters=iters, block=(8, 16), interpret=True)
    got, unresolved = chase_pass(_t(v0), _t(dirs), _t(fg), iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(unresolved) == int(np.sum(fg & (np.asarray(want) == 0)))


@pytest.mark.parametrize("seed", [0, 1])
def test_chase_resolve_twin_matches_pallas(seed):
    fg, dirs, v0 = _chase_inputs(seed)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_chase_resolve(v0, dirs, jnp.asarray(fg)))
    got = chase_resolve(_t(v0), _t(dirs), _t(fg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_chase_resolve_multi_pass_and_cap():
    """An x-ramp with its only root at the far end: chains up to 127 long
    need 16 passes of 8; a 3-pass cap leaves the far voxels unresolved,
    exactly as the Pallas loop does."""
    ramp = np.broadcast_to(np.arange(SHAPE[2], dtype=np.float32) / 1000.0,
                           SHAPE).copy()
    fg = np.ones(SHAPE, np.float32)
    dirs, v0 = _ref_v0(ramp, fg, 0.5, 0.5, 2)      # no seeds: negative roots
    fgm = fg >= 0.5
    for max_passes in (128, 3):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(ref_chase_resolve(v0, dirs, jnp.asarray(fgm),
                                                max_passes=max_passes))
        got = chase_resolve(_t(v0), _t(dirs), _t(fgm), max_passes=max_passes)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()                       # the cap really bit
    assert (chase_resolve_plain(_t(v0), _t(dirs), _t(fgm)) != 0).all()


# ---------------------------------------------------------------- K3 flood


def _flood_inputs(seed, fg_thr):
    fg_prob, peak = _blob_maps(seed)
    fg = fg_prob >= fg_thr
    seeds = np.asarray(ref_peak_nms(jnp.asarray(peak), 0.5, 2)) & fg
    idx = np.arange(np.prod(SHAPE), dtype=np.int32).reshape(SHAPE)
    return np.where(seeds, idx + 1, 0).astype(np.int32), fg, fg_prob


def _plateau_flood_inputs(seed, fg_thr):
    """A flat potential (two levels) with holes and 24 random seeds: fronts
    from different seeds meet on plateaus, so most choices fall to the
    linear-index tie-break (as on saturated bf16 probability maps)."""
    rng = np.random.default_rng(seed)
    fg_prob = np.where(rng.random(SHAPE) < 0.1, 0.0,
                       np.where(rng.random(SHAPE) < 0.5, 0.75, 1.0))
    fg_prob = fg_prob.astype(np.float32)
    fg = fg_prob >= fg_thr
    pick = rng.choice(np.flatnonzero(fg), 24, replace=False)
    seed_labels = np.zeros(np.prod(SHAPE), np.int32)
    seed_labels[pick] = pick + 1
    return seed_labels.reshape(SHAPE), fg, fg_prob


@pytest.mark.parametrize("inputs,seed", [(_flood_inputs, 0),
                                         (_flood_inputs, 1),
                                         (_plateau_flood_inputs, 2)])
def test_flood_resolve_twin_matches_pallas(inputs, seed):
    seed_labels, fg, fg_prob = inputs(seed, 0.5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_flood_resolve(
            jnp.asarray(seed_labels), jnp.asarray(fg), jnp.asarray(fg_prob), 24))
    want_xla = np.asarray(ref_flood_labels(
        jnp.asarray(seed_labels), jnp.asarray(fg), jnp.asarray(fg_prob), 24))
    np.testing.assert_array_equal(want, want_xla)
    got = flood_resolve(_t(seed_labels), _t(fg), _t(fg_prob), 24)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("inputs", [_flood_inputs, _plateau_flood_inputs])
@pytest.mark.parametrize("iters", [3, 5, 11])
def test_flood_resolve_twin_capped_matches_pallas(iters, inputs):
    """Capped flood: exactly ``iters`` lockstep steps, remainder pass
    included (test_flood_resolve_capped_matches_xla_cap)."""
    seed_labels, fg, fg_prob = inputs(3, 0.2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_flood_resolve(
            jnp.asarray(seed_labels), jnp.asarray(fg), jnp.asarray(fg_prob),
            iters))
    want_xla = np.asarray(ref_flood_labels(
        jnp.asarray(seed_labels), jnp.asarray(fg), jnp.asarray(fg_prob), iters,
        unroll_static=True))
    np.testing.assert_array_equal(want, want_xla)
    got = flood_resolve_plain(_t(seed_labels), _t(fg), _t(fg_prob), iters)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flood_ragged_shape_matches_xla():
    shape = (13, 37, 100)
    fg_prob, peak = _blob_maps(4, shape)
    fg = fg_prob >= 0.3
    seeds = np.asarray(ref_peak_nms(jnp.asarray(peak), 0.5, 2)) & fg
    idx = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    seed_labels = np.where(seeds, idx + 1, 0).astype(np.int32)
    for iters in (7, 40):
        want = np.asarray(ref_flood_labels(
            jnp.asarray(seed_labels), jnp.asarray(fg), jnp.asarray(fg_prob),
            iters))
        got = flood_resolve(_t(seed_labels), _t(fg), _t(fg_prob), iters)
        np.testing.assert_array_equal(got.numpy(), want)
