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
launch and the ``changed`` flag. The models follow the kernels step by step
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
from tpuseg.ops.pallas_resolve import flood_pass as ref_flood_pass
from tpuseg_torch.ops.resolve import chase_pass_plain, flood_pass_plain

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
