"""Models of the arithmetic of the two watershed resolve kernels of the port
(``tpuseg_torch/csrc/common.cuh``: the chase's hop walk; ``csrc/flood.cuh``:
the time-blocked flood) in numpy, held elementwise against the plain twins
``chase_pass_plain`` / ``flood_pass_plain`` and against the JAX package's
Pallas ``chase_pass`` / ``flood_pass`` in interpret mode.

A CUDA kernel cannot run on the CPU, but what decides whether it is right
can: the hop walk with its early stops and its zero outside the volume, and
for the flood the windows with their halo (level t runs only t or more
positions inside a window's edge), the ring of plane slots and its reuse,
the state bytes that let all time levels share one copy of a plane, the
fixed candidate order that stands for the linear-index tie-break, the
masking by coordinate, the write-back of the core alone, the remainder
launch and the ``changed`` flag. The loops around the passes run on the
card too (``tpuseg_chase_resolve`` / ``tpuseg_flood_resolve``): every pass
the loop may run is launched and gated on the previous pass's count or flag,
each in a slot of its own, with the chase's first idle pass copying its
input; their models are held against the JAX package's
``chase_resolve`` / ``flood_resolve`` (interpret mode) and against the
port's loops on the CPU, passes run included. The models follow the kernels step by step
(the names are the kernels'), at small tiles so that small volumes have
several windows and z chunks. What they leave out is how the flood kernel
shares the work among threads (four x positions a thread, their state bytes
compared as one word): that changes no voxel's arithmetic.

All outputs are integers, so every comparison is exact (no tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops.pallas_resolve import chase_pass as ref_chase_pass
from tpuseg.ops.pallas_resolve import chase_resolve as ref_chase_resolve
from tpuseg.ops.pallas_resolve import flood_pass as ref_flood_pass
from tpuseg.ops.pallas_resolve import flood_resolve as ref_flood_resolve
from tpuseg_torch.ops.resolve import (chase_pass_plain, chase_resolve,
                                      flood_pass_plain, flood_resolve,
                                      passes_run)
from tpuseg_torch.ops.watershed import steepest_dir_codes

from test_torch_model import single_torch_thread  # noqa: F401

ITERS = (1, 3, 8, 11)
# ragged, one plane, one row, fewer planes than steps per launch
SHAPES = ((6, 13, 21), (1, 9, 10), (3, 1, 17), (2, 11, 7))
PALLAS_SHAPE = (8, 16, 128)           # divisible by the Pallas blocks

K_OPEN, K_INERT, K_OUT = 253, 254, 255
POISON = -777                          # a slot that was never stored


# ------------------------------------------------------------ K2: hop walk


def chase_walk_model(values, dirs, iters):
    """``chase_walk_kernel``: every voxel follows the codes for up to
    ``iters`` hops (a code outside 1..6 ends the walk, a hop out of the
    volume yields 0) and reads ``values`` once, where it arrived."""
    d_, h_, w_ = values.shape
    cz, cy, cx = np.meshgrid(np.arange(d_), np.arange(h_), np.arange(w_),
                             indexing="ij")
    inside = np.ones(values.shape, bool)
    walking = np.ones(values.shape, bool)
    for _ in range(iters):
        d = dirs[cz, cy, cx]
        walking &= (d >= 1) & (d <= 6)
        step = walking.astype(np.int64)
        cz = cz + step * ((d == 1).astype(int) - (d == 2))
        cy = cy + step * ((d == 3).astype(int) - (d == 4))
        cx = cx + step * ((d == 5).astype(int) - (d == 6))
        left = ((cz < 0) | (cz >= d_) | (cy < 0) | (cy >= h_) | (cx < 0)
                | (cx >= w_))
        inside &= ~left
        walking &= ~left
        cz, cy, cx = (np.clip(c, 0, n - 1)
                      for c, n in ((cz, d_), (cy, h_), (cx, w_)))
    return np.where(inside, values[cz, cy, cx], 0).astype(np.int32)


def _chase_inputs(shape, seed):
    """Random int32 payloads (zeros included) and random codes 0..6, many of
    which point out of the volume at its faces."""
    rng = np.random.default_rng(seed)
    values = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    values[rng.random(shape) < 0.3] = 0
    dirs = rng.integers(0, 7, shape).astype(np.int32)
    fg = rng.random(shape) < 0.6
    return values, dirs, fg


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_chase_walk_model_matches_twin(shape, iters):
    values, dirs, fg = _chase_inputs(shape, seed=iters)
    want, n_want = chase_pass_plain(torch.from_numpy(values),
                                    torch.from_numpy(dirs),
                                    torch.from_numpy(fg), iters)
    got = chase_walk_model(values, dirs, iters)
    np.testing.assert_array_equal(got, want.numpy())
    assert int(n_want) == int(np.sum(fg & (got == 0)))


def test_chase_walk_model_code_out_of_range_is_self():
    """Codes outside 0..6 stay put, as in the twin (no mask matches them)."""
    values, dirs, fg = _chase_inputs((4, 5, 6), seed=7)
    dirs[::2, ::2, ::3] = 9
    dirs[1::2, 1::2, ::2] = -3
    want, _ = chase_pass_plain(torch.from_numpy(values),
                               torch.from_numpy(dirs), torch.from_numpy(fg), 5)
    np.testing.assert_array_equal(chase_walk_model(values, dirs, 5),
                                  want.numpy())


@pytest.mark.parametrize("iters", ITERS)
def test_chase_walk_model_matches_pallas(iters):
    values, dirs, _ = _chase_inputs(PALLAS_SHAPE, seed=10 + iters)
    want = ref_chase_pass(jnp.asarray(values), jnp.asarray(dirs), iters=iters,
                          block=(8, 16), interpret=True)
    np.testing.assert_array_equal(chase_walk_model(values, dirs, iters),
                                  np.asarray(want))


# ------------------------------------------------- K3: time-blocked flood


def _shifted(a, dy, dx, fill):
    """a[wy + dy, wx + dx] within a window plane, ``fill`` beyond its edge."""
    out = np.full_like(a, fill)
    wy, wx = a.shape
    ys = slice(max(-dy, 0), wy - max(dy, 0))
    xs = slice(max(-dx, 0), wx - max(dx, 0))
    yd = slice(max(dy, 0), wy - max(-dy, 0))
    xd = slice(max(dx, 0), wx - max(-dx, 0))
    out[ys, xs] = a[yd, xd]
    return out


def flood_launch_model(pot, lab, h, hmax, tile, zchunk):
    """One launch of ``flood_march_kernel``: ``h <= hmax`` lockstep steps.
    Returns ``(labels, changed)``; every voxel is written exactly once."""
    d_, h_, w_ = lab.shape
    ty, tx = tile
    wy_, wx_ = ty + 2 * hmax, tx + 2 * hmax
    nslot = hmax + 2
    out = np.full_like(lab, POISON)
    written = np.zeros(lab.shape, int)
    changed = False
    for za in range(0, d_, zchunk):
        zb = min(za + zchunk, d_)
        lo, hi = max(za - h, 0), min(zb + h, d_)
        for by in range(-(-h_ // ty)):
            for bx in range(-(-w_ // tx)):
                gy = by * ty - hmax + np.arange(wy_)
                gx = bx * tx - hmax + np.arange(wx_)
                in_vol = (((gy >= 0) & (gy < h_))[:, None]
                          & ((gx >= 0) & (gx < w_))[None, :])
                cy, cx = np.clip(gy, 0, h_ - 1), np.clip(gx, 0, w_ - 1)
                wy, wx = np.arange(wy_)[:, None], np.arange(wx_)[None, :]
                margin = np.minimum(np.minimum(wy, wy_ - 1 - wy),
                                    np.minimum(wx, wx_ - 1 - wx))
                s_lab = np.full((nslot, wy_, wx_), POISON, np.int32)
                s_pot = np.full((nslot, wy_, wx_), np.inf, np.float32)
                s_st = np.zeros((nslot, wy_, wx_), np.uint8)   # "giver"
                open_mask = [False] * nslot

                def fetch(z):
                    rl = np.where(in_vol, lab[z][np.ix_(cy, cx)], 0)
                    rp = np.where(in_vol, pot[z][np.ix_(cy, cx)], -np.inf)
                    return rl.astype(np.int32), rp.astype(np.float32)

                def store(z, rl, rp):
                    slot = (z - lo) % nslot
                    st = np.where(rl != 0, np.where(rl > 0, 0, K_INERT),
                                  np.where(rp > -np.inf, K_OPEN, K_INERT))
                    st = np.where(in_vol, st, K_OUT).astype(np.uint8)
                    s_lab[slot], s_pot[slot], s_st[slot] = rl, rp, st
                    open_mask[slot] = bool((st == K_OPEN).any())

                def level(t, z):
                    base = (z - lo) % nslot
                    up, dn = (z + 1 - lo) % nslot, (z - 1 - lo + nslot) % nslot
                    st0 = s_st[base].copy()
                    best = np.full((wy_, wx_), -np.inf, np.float32)
                    accepted = np.zeros((wy_, wx_), bool)
                    take = np.zeros((wy_, wx_), bool)
                    lbl = np.zeros((wy_, wx_), np.int32)
                    plane = (st0, s_pot[base], s_lab[base])

                    def in_plane(dy, dx):
                        return (_shifted(plane[0], dy, dx, K_OUT),
                                _shifted(plane[1], dy, dx, 0),
                                _shifted(plane[2], dy, dx, 0))

                    def other(slot, there):
                        if not there:       # outside the fetched z range
                            return (np.full((wy_, wx_), K_OUT, np.uint8),
                                    s_pot[slot], s_lab[slot])
                        return s_st[slot], s_pot[slot], s_lab[slot]

                    # descending linear index: z+1, y+1, x+1, x-1, y-1, z-1
                    for st, key_, lab_ in (other(up, z + 1 < hi),
                                           in_plane(1, 0), in_plane(0, 1),
                                           in_plane(0, -1), in_plane(-1, 0),
                                           other(dn, z - 1 >= lo)):
                        giver = st < t
                        key = np.where(giver, key_, -np.inf).astype(np.float32)
                        now = (st != K_OUT) & ((key > best)
                                               | (~accepted & (key == best)))
                        best = np.where(now, key, best)
                        accepted |= now
                        take = np.where(now, giver, take)
                        lbl = np.where(now & giver, lab_, lbl)
                    upd = (st0 == K_OPEN) & take & (margin >= t)
                    s_lab[base][upd] = lbl[upd]
                    s_st[base][upd] = t

                store(lo, *fetch(lo))
                for s in range(lo, hi + h):
                    more = s + 1 < hi
                    if more:
                        regs = fetch(s + 1)
                    for t in range(1, h + 1):
                        z = s - t
                        if z < lo or z >= hi or not open_mask[(z - lo) % nslot]:
                            continue
                        level(t, z)
                    zo = s - h
                    if za <= zo < zb:
                        slot = (zo - lo) % nslot
                        core = (slice(hmax, hmax + ty), slice(hmax, hmax + tx))
                        ok = in_vol[core]
                        ys, xs = np.nonzero(ok)
                        out[zo, gy[core[0]][ys], gx[core[1]][xs]] = \
                            s_lab[slot][core][ok]
                        written[zo, gy[core[0]][ys], gx[core[1]][xs]] += 1
                        st = s_st[slot][core][ok]
                        changed |= bool(((st >= 1) & (st <= hmax)).any())
                    if more:
                        store(s + 1, *regs)
    assert (written == 1).all()
    return out, changed


def flood_pass_model(pot, lab, iters, hmax=4, tile=(4, 8), zchunk=4):
    """``tpuseg_flood_pass``: launches of ``hmax`` steps and the remainder."""
    changed = False
    for k in range(0, iters, hmax):
        lab, ch = flood_launch_model(pot, lab, min(hmax, iters - k), hmax,
                                     tile, zchunk)
        changed |= ch
    return lab, changed


def _flood_inputs(shape, seed, kind):
    """``plateaus``: a potential of four levels, -inf off the foreground, a
    few positive labels on the foreground: fronts meet on ties. ``any``:
    what the contract still takes: labels of either sign anywhere (also off
    the foreground, where a giver has key -inf), and potentials of +inf."""
    rng = np.random.default_rng(seed)
    pot = (rng.integers(0, 4, shape) / 4).astype(np.float32)
    pot[rng.random(shape) < 0.25] = -np.inf
    lab = np.zeros(shape, np.int32)
    n = int(np.prod(shape))
    if kind == "plateaus":
        pick = rng.choice(n, max(n // 40, 1), replace=False)
        lab.reshape(-1)[pick] = pick + 1
        lab[pot == -np.inf] = 0
    else:
        pick = rng.random(shape) < 0.08
        lab[pick] = rng.integers(-5, 50, shape)[pick]
        pot[rng.random(shape) < 0.03] = np.inf
    return pot, lab


def _check_flood(pot, lab, iters, **kw):
    want, ch_want = flood_pass_plain(torch.from_numpy(pot),
                                     torch.from_numpy(lab), iters)
    got, ch_got = flood_pass_model(pot, lab, iters, **kw)
    np.testing.assert_array_equal(got, want.numpy())
    assert ch_got == bool(ch_want)
    return got


@pytest.mark.parametrize("kind", ["plateaus", "any"])
@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_flood_march_model_matches_twin(shape, iters, kind):
    pot, lab = _flood_inputs(shape, seed=iters, kind=kind)
    got = _check_flood(pot, lab, iters)
    assert (got != lab).any() or kind == "any"      # the flood really moved


@pytest.mark.parametrize("hmax,tile,zchunk", [(8, (4, 8), 100), (4, (16, 64), 3),
                                              (2, (3, 5), 2), (1, (2, 2), 1)])
def test_flood_march_model_geometry(hmax, tile, zchunk):
    """Other steps per launch, tiles and z chunks than the default model's:
    the result does not depend on them."""
    pot, lab = _flood_inputs((6, 13, 21), seed=3, kind="plateaus")
    for iters in (5, 8):
        _check_flood(pot, lab, iters, hmax=hmax, tile=tile, zchunk=zchunk)


def test_flood_march_model_nan_potential_never_wins():
    pot, lab = _flood_inputs((4, 9, 10), seed=5, kind="any")
    pot[::2, ::3, ::2] = np.nan
    _check_flood(pot, lab, 6)


def test_flood_march_model_changed_only_in_core():
    """Nothing open: no launch may report a change, whatever the halos
    recompute; one open voxel next to a giver: changed, once, then not."""
    pot = np.zeros((3, 9, 17), np.float32)
    lab = np.ones((3, 9, 17), np.int32)
    got, changed = flood_pass_model(pot, lab, 8)
    assert not changed and (got == lab).all()
    lab[1, 4, 8] = 0
    got, changed = flood_pass_model(pot, lab, 8)
    assert changed and got[1, 4, 8] == 1
    again, changed = flood_pass_model(pot, got, 8)
    assert not changed and (again == got).all()


@pytest.mark.parametrize("iters", ITERS)
def test_flood_march_model_matches_pallas(iters):
    pot, lab = _flood_inputs(PALLAS_SHAPE, seed=20 + iters, kind="plateaus")
    want = ref_flood_pass(jnp.asarray(pot), jnp.asarray(lab), iters=iters,
                          block=(8, 8), interpret=True)
    got, _ = flood_pass_model(pot, lab, iters, tile=(8, 32), zchunk=8)
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------- the loops, gated on the device


def chase_resolve_model(values, dirs, fg, iters, max_passes):
    """``tpuseg_chase_resolve``: ``max_passes`` passes launched. Pass k
    reads the caller's volume (k = 1) or the buffer pass k - 1 wrote and
    writes b1 (k odd) or b2 (k even); it runs iff its gate, slot k - 1, is
    nonzero (slot 0: foreground zeros of the input) and then puts its count
    in slot k; an idle pass copies its input when k <= 2 or pass k - 1 ran.
    Returns ``(the buffer of pass max_passes, passes run, slots)``."""
    if max_passes < 1:
        return values, 0, None
    slots = np.zeros(max_passes + 1, np.int64)
    slots[0] = np.sum(fg & (values == 0))
    bufs = {"in": values, "b1": np.full_like(values, POISON),
            "b2": np.full_like(values, POISON)}
    ran = 0
    for k in range(1, max_passes + 1):
        src = "in" if k == 1 else ("b1" if k % 2 == 0 else "b2")
        dst = "b1" if k % 2 else "b2"
        if slots[k - 1] != 0:
            bufs[dst] = chase_walk_model(bufs[src], dirs, iters)
            slots[k] = np.sum(fg & (bufs[dst] == 0))
            ran += 1
        elif k <= 2 or slots[k - 2] != 0:
            bufs[dst] = bufs[src].copy()
    return bufs["b1" if max_passes % 2 else "b2"], ran, slots


def flood_resolve_model(seed_labels, fg, potential, max_iters, iters_per_pass,
                        **kw):
    """``tpuseg_flood_resolve``: the whole passes and the remainder
    launched, pass k from b0 (k odd) or b1 into the other; whole pass k runs
    iff slot k - 1 is set (slot 0 is 1) and sets slot k if it changed a
    label; the remainder is gated on slot ``full``. An idle pass does
    nothing: its gate says the last pass that ran left its input as it was.
    Returns ``(the buffer of the last pass launched, passes run)``."""
    pot = np.where(fg, potential, -np.inf).astype(np.float32)
    bufs = [np.where(fg, seed_labels, 0).astype(np.int32),
            np.full(seed_labels.shape, POISON, np.int32)]
    full, rem = divmod(max_iters, iters_per_pass)
    full = max(full, 0)
    launched = full + (rem > 0)
    slots = np.zeros(full + 2, np.int64)
    slots[0] = 1
    ran = 0
    for k in range(1, launched + 1):
        if slots[k - 1]:
            steps = iters_per_pass if k <= full else rem
            bufs[k % 2], changed = flood_pass_model(pot, bufs[(k + 1) % 2],
                                                    steps, **kw)
            slots[k] = changed
            ran += 1
    return bufs[launched % 2], ran


def _plateau_row(n):
    """A 1 x 1 x n foreground row of constant peak: every voxel points at
    its +x neighbour, the last voxel is the one seeded root, so the chain is
    n - 1 hops long and resolves in ceil((n - 1) / 8) passes of 8."""
    peak = np.full((1, 1, n), 0.7, np.float32)
    fg = np.ones((1, 1, n), bool)
    dirs = steepest_dir_codes(torch.from_numpy(peak),
                              torch.from_numpy(fg)).numpy()
    v0 = np.zeros((1, 1, n), np.int32)
    v0[0, 0, -1] = n
    return peak, fg, dirs, v0


def _port_chase(values, dirs, fg, iters, max_passes):
    """The port's labels, passes run and gates (its host loop's slots)."""
    got = chase_resolve(torch.from_numpy(values), torch.from_numpy(dirs),
                        torch.from_numpy(fg), iters, max_passes).numpy()
    gates = chase_resolve.last_gates
    return got, passes_run(gates), gates.numpy()


# (row length, max_passes, passes that run): one pass; convergence after 5;
# the cap before convergence (the 128-pass cap at its own scale); an input
# already resolved (no pass runs: passes 1 and 2 copy); one and two passes
# launched
CHASE_CASES = [(6, 128, 1), (40, 128, 5), (100, 4, 4), (1, 128, 0),
               (30, 1, 1), (30, 2, 2), (9, 3, 1)]


@pytest.mark.parametrize("n,max_passes,runs", CHASE_CASES)
def test_chase_resolve_model_matches_reference(n, max_passes, runs):
    _, fg, dirs, v0 = _plateau_row(n)
    got, ran, slots = chase_resolve_model(v0, dirs, fg, 8, max_passes)
    assert ran == runs and (got != POISON).all()
    want = np.asarray(ref_chase_resolve(
        jnp.asarray(v0), jnp.asarray(dirs), jnp.asarray(fg), iters_per_pass=8,
        max_passes=max_passes, block=(1, 1), interpret=True))
    np.testing.assert_array_equal(got, want)
    port, port_ran, gates = _port_chase(v0, dirs, fg, 8, max_passes)
    np.testing.assert_array_equal(got, port)
    assert port_ran == ran
    # the gates: every pass that ran saw a nonzero slot, every idle one 0,
    # and the host loop read the counts the slots hold
    assert (slots[:max_passes] != 0).sum() == ran
    np.testing.assert_array_equal(gates, slots[:gates.size])


def test_chase_resolve_model_on_watershed_chains():
    """Many chains of many lengths from steepest ascent on blob maps, a
    third of the roots unseeded (negative payloads)."""
    rng = np.random.default_rng(4)
    shape = PALLAS_SHAPE
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij")
    peak = np.zeros(shape, np.float32)
    for _ in range(6):
        c = [rng.uniform(0, s) for s in shape]
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + ((xx - c[2]) / 6) ** 2
        peak = np.maximum(peak, np.exp(-0.5 * d2 / 3.0 ** 2))
    peak = (peak + rng.normal(0, 0.002, shape)).astype(np.float32)
    fg = peak > 0.05
    dirs = steepest_dir_codes(torch.from_numpy(peak),
                              torch.from_numpy(fg)).numpy()
    lin = np.arange(peak.size).reshape(shape) + 1
    roots = fg & (dirs == 0)
    v0 = np.where(roots, np.where(rng.random(shape) < 0.66, lin, -lin),
                  0).astype(np.int32)
    for max_passes in (2, 128):
        got, ran, _ = chase_resolve_model(v0, dirs, fg, 8, max_passes)
        want = np.asarray(ref_chase_resolve(
            jnp.asarray(v0), jnp.asarray(dirs), jnp.asarray(fg),
            iters_per_pass=8, max_passes=max_passes, block=(8, 16),
            interpret=True))
        np.testing.assert_array_equal(got, want)
        port, port_ran, _ = _port_chase(v0, dirs, fg, 8, max_passes)
        np.testing.assert_array_equal(got, port)
        assert port_ran == ran >= 2
    assert ran < 128 and not (fg & (got == 0)).any()      # converged


def _port_flood(seeds, fg, pot, max_iters, iters_per_pass):
    got = flood_resolve(torch.from_numpy(seeds), torch.from_numpy(fg),
                        torch.from_numpy(pot), max_iters,
                        iters_per_pass).numpy()
    return got, passes_run(flood_resolve.last_gates)


# (max_iters, iters_per_pass): one whole pass; convergence long before the
# cap (the remainder gated off); a cap with a remainder (max_iters %
# iters_per_pass != 0) that runs; no whole pass (the remainder ungated);
# nothing at all
FLOOD_CASES = [(8, 8), (96, 8), (13, 8), (5, 8), (0, 8), (10, 3)]


@pytest.mark.parametrize("max_iters,iters_per_pass", FLOOD_CASES)
def test_flood_resolve_model_matches_reference(max_iters, iters_per_pass):
    pot, lab = _flood_inputs(PALLAS_SHAPE, seed=30 + max_iters,
                             kind="plateaus")
    fg = pot > -np.inf
    lab = np.where(np.random.default_rng(max_iters).random(lab.shape) < 0.3,
                   lab, 0).astype(np.int32)            # fewer seeds: longer
    got, ran = flood_resolve_model(lab, fg, pot, max_iters, iters_per_pass,
                                   tile=(8, 32), zchunk=8)
    assert (got != POISON).all()
    want = np.asarray(ref_flood_resolve(
        jnp.asarray(lab), jnp.asarray(fg), jnp.asarray(pot), max_iters,
        iters_per_pass=iters_per_pass, block=(8, 8), interpret=True))
    np.testing.assert_array_equal(got, want)
    port, port_ran = _port_flood(lab, fg, pot, max_iters, iters_per_pass)
    np.testing.assert_array_equal(got, port)
    assert port_ran == ran
    full, rem = divmod(max_iters, iters_per_pass)
    assert ran <= full + (rem > 0)
    if max_iters == 96:
        assert ran < full                            # converged early
    if max_iters in (13, 5, 10):
        assert ran == full + 1                       # the remainder ran


def test_flood_resolve_model_remainder_gated_off():
    """A flood that stops changing within its whole passes skips the
    remainder: the last whole pass that ran found nothing to change."""
    pot = np.zeros((2, 8, 32), np.float32)
    lab = np.zeros((2, 8, 32), np.int32)
    lab[0, 0, 0] = 1
    fg = np.ones(pot.shape, bool)
    got, ran = flood_resolve_model(lab, fg, pot, 8 * 20 + 3, 8, tile=(8, 32),
                                   zchunk=8)
    assert (got == 1).all() and ran < 20
    port, port_ran = _port_flood(lab, fg, pot, 8 * 20 + 3, 8)
    np.testing.assert_array_equal(got, port)
    assert port_ran == ran
