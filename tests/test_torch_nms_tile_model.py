"""A numpy model of the tile pass that computes K1's and K5's seeds on the
card (``tpuseg_torch/csrc/nms.cuh``: ``nms_tile_kernel``), held against the
plain twins on the adversarial maps of ``tpuseg_torch/ops/nms_cases.py``.

The CUDA kernel cannot run on the CPU; its arithmetic can. The model walks
the same blocks ((32, 32) tiles of (y, x) with a halo of 2r, z chunks with
their pre-roll, four planes a step), keeps the same state (raw planes that
become cidx planes, x-pooled planes, the two z rings of 2 rz + 1 planes and
the flag ring) and takes the same decisions: a candidate is a voxel whose flag ``peak == 2-D pool`` is set and
whose pooled value is >= thr and >= the ring's max; a seed is a voxel whose
pooled candidate index equals its own linear index; both poolings are
skipped for a step with no value >= thr or no candidate; K1's ascent
step is taken per core voxel once its seed status is known. Change it with
the kernel. Every output is an integer or a boolean: comparisons are exact.
"""

import numpy as np
import pytest
import torch

from tpuseg_torch.ops.nms_cases import (CHAIN_RADII, SMALL_SHAPE,
                                        THRESHOLD, TILE_RADII,
                                        adversarial_maps,
                                        expected_constant_seeds)
from tpuseg_torch.ops.peaks import (SMEM_OPTIN_H100, TILE_MAX_RADIUS,
                                    TILE_PLANES, TILE_YX, nms_body,
                                    nms_tile_smem_bytes, peak_nms)
from tpuseg_torch.ops.seed import seed_chase_pass_plain

from test_torch_model import single_torch_thread  # noqa: F401

NEG = np.float32(-np.inf)


def _pool(a, r, axis, fill):
    """Max over [p - r, p + r] along ``axis``; positions whose window leaves
    the array get ``fill`` (the kernel never reads them)."""
    out = np.full_like(a, fill)
    n = a.shape[axis]
    if n <= 2 * r:
        return out
    acc = None
    for o in range(2 * r + 1):
        part = np.take(a, range(o, n - 2 * r + o), axis=axis)
        acc = part if acc is None else np.maximum(acc, part)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(r, n - r)
    out[tuple(idx)] = acc
    return out


def _ascent_code(peak, fgp, fg_thr, i, z, y, x):
    """``nms.cuh: ascent_code`` for one foreground voxel."""
    D, H, W = peak.shape
    hw = H * W
    flat_p, flat_f = peak.ravel(), fgp.ravel()
    has = (z + 1 < D, z > 0, y + 1 < H, y > 0, x + 1 < W, x > 0)
    off = (hw, -hw, W, -W, 1, -1)
    best_pot, best_idx, code = flat_p[i], i, 0
    for c in range(6):
        if not has[c]:
            continue
        j = i + off[c]
        npot = flat_p[j] if flat_f[j] >= fg_thr else NEG
        if npot > best_pot or (npot == best_pot and j > best_idx):
            best_pot, best_idx, code = npot, j, c + 1
    return code


def tile_pass_model(peak, fgp, thr, fg_thr, radius, dirs: bool, zchunks=0):
    """The seed mask (``dirs`` false) or ``(dirs, v0)`` as the tile pass
    computes them, block by block and step by step."""
    rz, ry, rx = radius
    D, H, W = peak.shape
    ty_, tx_ = TILE_YX
    hy, hx = 2 * ry, 2 * rx
    WY, WX = ty_ + 2 * hy, tx_ + 2 * hx
    nr = 2 * rz + 1
    ntiles = -(-H // ty_) * -(-W // tx_)
    nz = zchunks or min(-(-132 // ntiles), D // 24)
    nz = max(min(nz, D), 1)
    zchunk = -(-D // nz)
    ey = np.minimum(np.arange(WY), WY - 1 - np.arange(WY))[:, None]
    ex = np.minimum(np.arange(WX), WX - 1 - np.arange(WX))[None, :]
    r_cand = (ex >= rx) & (ey >= ry)
    r_poolxi = (ex >= hx) & (ey >= ry)
    r_core = (ex >= hx) & (ey >= hy)
    seeds = np.zeros(peak.shape, bool)
    out_dirs = np.full(peak.shape, -7, np.int32)
    out_v0 = np.full(peak.shape, -7, np.int32)
    for za in range(0, D, zchunk):
        zb = min(za + zchunk, D)
        for y0 in range(0, H, ty_):
            for x0 in range(0, W, tx_):
                gy = y0 - hy + np.arange(WY)[:, None]
                gx = x0 - hx + np.arange(WX)[None, :]
                inside = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
                cy, cx = np.clip(gy, 0, H - 1), np.clip(gx, 0, W - 1)
                sg = np.where(inside, gy * W + gx, -1)
                own = r_core & inside
                f = np.full((nr, WY, WX), NEG)
                g = np.full((nr, WY, WX), -1, np.int64)
                fl = np.zeros((nr, WY, WX), bool)      # fl[j]: plane zi - j
                for zo0 in range(za - 4 * rz, zb, TILE_PLANES):
                    planes = range(TILE_PLANES)
                    raw = [np.where(inside, peak[zo0 + p + 2 * rz][cy, cx], NEG)
                           if 0 <= zo0 + p + 2 * rz < D
                           else np.full((WY, WX), NEG) for p in planes]
                    any_hi = any(bool((r >= thr).any()) for r in raw)
                    cidx = []
                    for p in planes:
                        zc = zo0 + p + rz
                        b = np.full((WY, WX), NEG)
                        e = np.zeros((WY, WX), bool)
                        if any_hi:
                            s_a = _pool(raw[p], rx, 1, np.nan)
                            b = np.where(r_cand, _pool(s_a, ry, 0, np.nan), NEG)
                            assert not np.isnan(b).any()
                            e = (raw[p] == b) & r_cand
                        f = np.concatenate([f[1:], b[None]])
                        fl = np.concatenate([e[None], fl[:-1]])
                        fc = f[rz]
                        cand = np.zeros((WY, WX), bool)
                        if max(za - rz, 0) <= zc < D:
                            cand = (r_cand & inside & fl[rz] & (fc >= thr)
                                    & (fc >= f.max(axis=0)))
                        # -2: positions the kernel never writes or reads
                        cidx.append(np.where(
                            r_cand, np.where(cand, zc * H * W + sg, -1), -2))
                    any_c = any(bool((c >= 0).any()) for c in cidx)
                    for p in planes:
                        zo = zo0 + p
                        q = np.full((WY, WX), -1, np.int64)
                        if any_c:
                            s_ai = _pool(cidx[p], rx, 1, -2)
                            assert (s_ai[r_poolxi] >= -1).all()
                            q = np.where(r_core, _pool(s_ai, ry, 0, -2), -1)
                            assert (q[r_core] >= -1).all()
                        g = np.concatenate([g[1:], q[None]])
                        if not za <= zo < zb:
                            continue
                        is_seed = g.max(axis=0) == zo * H * W + sg
                        for wy, wx in zip(*np.nonzero(own)):
                            y, x = gy[wy, 0], gx[0, wx]
                            if not dirs:
                                seeds[zo, y, x] = is_seed[wy, wx]
                                continue
                            i = zo * H * W + sg[wy, wx]
                            fg = fgp[zo, y, x] >= fg_thr
                            seed = fg and is_seed[wy, wx]
                            code = 0
                            if fg and not seed:
                                code = _ascent_code(peak, fgp, fg_thr, i, zo,
                                                    y, x)
                            out_dirs[zo, y, x] = code
                            out_v0[zo, y, x] = (
                                (i + 1 if seed else -(i + 1))
                                if fg and code == 0 else 0)
    return (out_dirs, out_v0) if dirs else seeds


def _twin_seeds(peak, radius):
    return peak_nms(torch.from_numpy(peak), THRESHOLD, radius).numpy()


@pytest.mark.parametrize("radius", TILE_RADII)
def test_tile_model_seed_mask_small_shape(radius):
    """Extents below one tile, rz >= D for most radii."""
    for name, peak, _ in adversarial_maps(SMALL_SHAPE, seed=1):
        got = tile_pass_model(peak, None, np.float32(THRESHOLD), None, radius,
                              dirs=False)
        np.testing.assert_array_equal(got, _twin_seeds(peak, radius), name)
        if name == "constant":
            np.testing.assert_array_equal(
                got, expected_constant_seeds(SMALL_SHAPE, radius))


@pytest.mark.parametrize("radius", [(2, 2, 2), (0, 2, 1), (3, 1, 4)])
@pytest.mark.parametrize("zchunks", [0, 3])
def test_tile_model_seed_mask_across_tiles_and_chunks(radius, zchunks):
    """One more than a tile on y and x, plateaus across every tile edge and,
    with z chunks, across chunk edges."""
    shape = (13, 33, 65)
    for name, peak, _ in adversarial_maps(shape, seed=2):
        got = tile_pass_model(peak, None, np.float32(THRESHOLD), None, radius,
                              dirs=False, zchunks=zchunks)
        np.testing.assert_array_equal(got, _twin_seeds(peak, radius), name)


@pytest.mark.parametrize("radius,shape,zchunks", [
    ((2, 2, 2), (9, 33, 40), 2), ((0, 2, 1), (9, 33, 40), 0),
    ((1, 0, 3), (7, 35, 33), 3), ((0, 0, 0), (5, 33, 34), 2),
    ((4, 4, 4), SMALL_SHAPE, 0), ((3, 1, 4), (6, 10, 37), 0)])
def test_tile_model_dirs_and_roots(radius, shape, zchunks):
    """K1's outputs before the walk: direction codes and signed roots, with
    the foreground cutting through plateaus."""
    for name, peak, fgp in adversarial_maps(shape, seed=3):
        got_dirs, got_v0 = tile_pass_model(
            peak, fgp, np.float32(THRESHOLD), np.float32(0.5), radius,
            dirs=True, zchunks=zchunks)
        want_dirs, want_v0 = seed_chase_pass_plain(
            torch.from_numpy(peak), torch.from_numpy(fgp), THRESHOLD, 0.5,
            radius, h0=0)
        np.testing.assert_array_equal(got_dirs, want_dirs.numpy(), name)
        np.testing.assert_array_equal(got_v0, want_v0.numpy(), name)


def _nms_row(row, r):
    """Peak NMS of a 1-D row that sees nothing beyond its ends."""
    pad = np.concatenate([np.full(r, NEG), row, np.full(r, NEG)])
    mx = np.max([pad[o:o + row.size] for o in range(2 * r + 1)], axis=0)
    cidx = np.where((row >= 0.5) & (row >= mx), np.arange(row.size), -1)
    pad = np.concatenate([np.full(r, -1), cidx, np.full(r, -1)])
    midx = np.max([pad[o:o + row.size] for o in range(2 * r + 1)], axis=0)
    return (cidx >= 0) & (cidx == midx)


def test_one_radius_halo_would_be_wrong():
    """The case the 2r halo exists for. x = 31 and x = 33 tie at 0.9 and
    x = 35 holds 1.0, r = 2, the tile's core ends at x = 32. In truth 33 is
    no candidate (35 beats it), so 31 is a seed. A window with a halo of r
    ends at x = 34: there 33 sees nothing above it, calls itself a candidate
    and, with the larger index, suppresses 31. With 2r the window reaches
    35. The model (halo 2r) equals the twin."""
    r = 2
    row = np.zeros(80, np.float32)
    row[[31, 33]], row[35] = 0.9, 1.0
    want = _nms_row(row, r)
    assert want[31] and not want[33] and want[35]
    assert not _nms_row(row[:32 + r], r)[31]          # halo r: seed lost
    assert _nms_row(row[:32 + 2 * r], r)[31]          # halo 2r: kept
    peak = np.zeros((1, 3, 80), np.float32)
    peak[0, 1] = row
    np.testing.assert_array_equal(_twin_seeds(peak, (0, 0, r))[0, 1], want)
    got = tile_pass_model(peak, None, np.float32(0.5), None, (0, 0, r), False)
    np.testing.assert_array_equal(got, _twin_seeds(peak, (0, 0, r)))


# ------------------------------------------------------------- the body rule


def test_body_rule_takes_every_radius_up_to_the_limit():
    for rz in range(TILE_MAX_RADIUS + 1):
        for ry in range(TILE_MAX_RADIUS + 1):
            for rx in range(TILE_MAX_RADIUS + 1):
                r = (rz, ry, rx)
                assert nms_body(r) == "tile", r
                assert 0 < nms_tile_smem_bytes(r) <= SMEM_OPTIN_H100, r
    for r in TILE_RADII:
        assert nms_body(r) == "tile", r
    for r in CHAIN_RADII + ((0, 0, 5), (5, 5, 5), 7):
        assert nms_body(r) == "chain", r
    assert nms_body(2) == nms_body((2, 2, 2)) == "tile"


@pytest.mark.parametrize("ry", range(TILE_MAX_RADIUS + 1))
def test_body_rule_shared_memory_is_monotone(ry):
    top = TILE_MAX_RADIUS
    ty, tx = TILE_YX
    for rx in range(top + 1):
        here = nms_tile_smem_bytes((0, ry, rx))
        assert here == 3 * TILE_PLANES * (ty + 4 * ry) * (tx + 4 * rx) * 4
        if ry < top:
            assert nms_tile_smem_bytes((0, ry + 1, rx)) > here
        if rx < top:
            assert nms_tile_smem_bytes((0, ry, rx + 1)) > here
        # the z window lives in registers
        assert nms_tile_smem_bytes((top, ry, rx)) == here


def test_body_rule_follows_the_cards_limit_and_refuses_negatives():
    """A card with less opt-in shared memory than a window needs takes the
    chain; the decision is made from the arguments, before any launch."""
    need = nms_tile_smem_bytes((4, 4, 4))
    assert nms_body((4, 4, 4), smem_optin=need) == "tile"
    assert nms_body((4, 4, 4), smem_optin=need - 1) == "chain"
    assert nms_body((0, 0, 0), smem_optin=need - 1) == "tile"
    with pytest.raises(ValueError):
        nms_body((1, -1, 1))
