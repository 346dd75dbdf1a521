"""The port's plain ops (``tpuseg_torch/ops``, ``data``) == the JAX package's
on the same numpy inputs. Integer outputs (masks, codes, labels, counts) and
the percentile scalars are compared exactly: they are computed from
identical float32 inputs with the same float32 arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.data.normalize import histogram_percentile_scalars as ref_hist
from tpuseg.data.synthetic import synthesize_volume as ref_synth
from tpuseg.ops.filter import size_filter_and_compact as ref_filter
from tpuseg.ops.neighbors import NEIGHBORS_6 as REF_NEIGHBORS_6
from tpuseg.ops.neighbors import shift as ref_shift
from tpuseg.ops.peaks import _maxpool_same as ref_maxpool
from tpuseg.ops.peaks import peak_nms as ref_peak_nms
from tpuseg.ops.watershed import flood_truncation_count as ref_trunc
from tpuseg.ops.watershed import steepest_dir_codes as ref_dir_codes
from tpuseg.ops.watershed import watershed as ref_watershed
from tpuseg_torch.data import load_volume, save_volume, synthesize_volume
from tpuseg_torch.data.normalize import histogram_percentile_scalars
from tpuseg_torch.ops import (flood_truncation_count, peak_nms,
                              size_filter_and_compact, steepest_dir_codes,
                              watershed)
from tpuseg_torch.ops.neighbors import NEIGHBORS_6, linear_index, shift
from tpuseg_torch.ops.peaks import maxpool_same, radius3

from test_torch_model import single_torch_thread  # noqa: F401

SHAPE = (12, 20, 24)


def _t(a):
    return torch.from_numpy(np.array(a))      # writable copy


def _maps(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij")
    peak = np.zeros(shape, np.float32)
    for _ in range(5):
        c = [rng.uniform(2, s - 2) for s in shape]
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        peak = np.maximum(peak, np.exp(-0.5 * d2 / 2.5**2))
    peak = (peak + rng.normal(0, 0.01, shape)).astype(np.float32)
    fg = np.clip(peak * 1.5, 0, 1).astype(np.float32)
    return fg, peak


def test_neighbors_and_shift_match():
    assert tuple(NEIGHBORS_6) == tuple(REF_NEIGHBORS_6)
    x = np.random.default_rng(0).integers(-5, 5, SHAPE).astype(np.int32)
    for axis, off in NEIGHBORS_6:
        np.testing.assert_array_equal(
            shift(_t(x), axis, off, -7).numpy(),
            np.asarray(ref_shift(jnp.asarray(x), axis, off, jnp.int32(-7))))
    np.testing.assert_array_equal(linear_index(SHAPE).numpy().ravel(),
                                  np.arange(np.prod(SHAPE)))


@pytest.mark.parametrize("radius", [2, (1, 2, 2), (0, 1, 3)])
def test_peak_nms_matches(radius):
    _, peak = _maps(1)
    peak[3:6, 4:9, 5:7] = peak.max()               # plateau: index tie-break
    want = np.asarray(ref_peak_nms(jnp.asarray(peak), 0.3, radius))
    got = peak_nms(_t(peak), 0.3, radius).numpy()
    np.testing.assert_array_equal(got, want)
    assert radius3(radius) == tuple(radius3(radius))


def test_index_pool_exact_above_2_pow_24():
    """Linear indices past 2**24 (the 96x512x512 stack has 25.2M voxels):
    the int32 pool keeps every index; a float32 pool would merge them."""
    rng = np.random.default_rng(0)
    base = 2 ** 24 + 12345
    idx = (base + rng.permutation(6 * 8 * 10)).astype(np.int32).reshape(6, 8, 10)
    idx[rng.random(idx.shape) < 0.3] = -1
    for radius in ((1, 1, 1), (2, 0, 3)):
        want = np.asarray(ref_maxpool(jnp.asarray(idx), radius, jnp.int32(-1)))
        got = maxpool_same(_t(idx), radius, -1).numpy()
        np.testing.assert_array_equal(got, want)
        lossy = maxpool_same(_t(idx).float(), radius, -1.0).numpy()
        assert not np.array_equal(lossy.astype(np.int64), want)


def test_steepest_dir_codes_match():
    fg_prob, peak = _maps(2)
    fg = fg_prob >= 0.4
    seeds = np.asarray(ref_peak_nms(jnp.asarray(peak), 0.5, 2)) & fg
    want = np.asarray(ref_dir_codes(jnp.asarray(peak), jnp.asarray(fg),
                                    self_sticky=jnp.asarray(seeds)))
    got = steepest_dir_codes(_t(peak), _t(fg), self_sticky=_t(seeds)).numpy()
    np.testing.assert_array_equal(got, want)


def test_watershed_matches_reference():
    """Converged chase and flood: the port's Pallas-path composition equals
    the JAX package's XLA path on the CPU."""
    fg_prob, peak = _maps(3, (16, 32, 40))
    kw = dict(peak_threshold=0.5, fg_threshold=0.4, peak_radius=(1, 2, 2),
              flood_iters=48)
    want = np.asarray(ref_watershed(jnp.asarray(fg_prob), jnp.asarray(peak),
                                    ascent_rounds=None, **kw))
    got = watershed(_t(fg_prob), _t(peak), **kw).numpy()
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)
    # the twins, by name
    np.testing.assert_array_equal(
        watershed(_t(fg_prob), _t(peak), plain=True, **kw).numpy(), want)


@pytest.mark.parametrize("kw,exc,match", [
    ({"method": "bogus"}, ValueError, "unknown watershed method"),
    ({"label_space": "dense"}, NotImplementedError, "ROADMAP"),
    ({"nms_impl": "bogus"}, ValueError, "unknown nms_impl"),
    ({"resolve_impl": "bogus"}, ValueError, "unknown resolve_impl")],
    ids=["kw0", "kw1", "kw2", "kw3"])
def test_watershed_unported_settings_raise(kw, exc, match):
    """The dense label space, a TPU workaround that is not ported, raises
    NotImplementedError; unknown values raise ValueError, as in the JAX
    package (``method="flood"`` and ``nms_impl="pallas"`` are ported:
    tests/test_torch_nms.py; ``resolve_impl="xla"``:
    tests/test_torch_postproc_extras.py)."""
    fg_prob, peak = _maps(0)
    with pytest.raises(exc, match=match):
        watershed(_t(fg_prob), _t(peak), **kw)


def test_flood_truncation_count_matches():
    fg_prob, peak = _maps(4)
    fg = fg_prob >= 0.3
    labels = np.where(peak > 0.6, np.arange(peak.size).reshape(SHAPE) + 1,
                      0).astype(np.int32)
    want = int(ref_trunc(jnp.asarray(labels), jnp.asarray(fg)))
    got = flood_truncation_count(_t(labels), _t(fg))
    assert got.dtype == torch.int32 and int(got) == want > 0


@pytest.mark.parametrize("min_size", [1, 5, 40])
def test_size_filter_and_compact_matches(min_size):
    rng = np.random.default_rng(min_size)
    labels = rng.choice(np.array([0, 3, 17, 9000, 42, 5], np.int32), SHAPE,
                        p=[0.5, 0.2, 0.01, 0.15, 0.13, 0.01])
    want = np.asarray(ref_filter(jnp.asarray(labels), min_size))
    got = size_filter_and_compact(_t(labels), min_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pcts", [(1.0, 99.8), (0.3, 50.0), (25.0, 99.97)])
@pytest.mark.parametrize("seed,stride", [(0, 4), (1, 1), (2, 4)])
def test_histogram_percentile_scalars_match(seed, stride, pcts):
    """Low, middle and far-tail percentiles: each lands on the first bin
    whose float32 CDF reaches it, so equal scalars at all of them need equal
    bin counts and the same sequential float32 CDF."""
    rng = np.random.default_rng(seed)
    vol = (rng.gamma(2.0, 50.0, (16, 40, 52)) + 7).astype(np.float32)
    vol[rng.random(vol.shape) < 0.01] = 900.0     # a bright tail
    want = ref_hist(jnp.asarray(vol), pcts, sample_stride=stride)
    got = histogram_percentile_scalars(_t(vol), pcts, sample_stride=stride)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.item() == float(w)               # bit-exact


@pytest.mark.parametrize("seed", [0, 7])
def test_synthesize_volume_bit_identical(seed):
    kw = dict(shape=(24, 48, 40), num_instances=9, radius_range=(3.0, 6.0),
              seed=seed)
    a, b = synthesize_volume(**kw), ref_synth(**kw)
    for field in ("image", "labels", "centers", "half_sizes"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ext", [".npy", ".npz"])
def test_volume_io_roundtrip(tmp_path, ext):
    vol = np.arange(60, dtype=np.int32).reshape(3, 4, 5)
    path = str(tmp_path / f"v{ext}")
    save_volume(path, vol)
    np.testing.assert_array_equal(load_volume(path), vol)
    with pytest.raises(ValueError, match="unsupported volume extension"):
        load_volume(str(tmp_path / "v.zarr"))


@pytest.mark.parametrize("frac,stride", [(0.05, 1), (0.3, 4), (0.0, 1)])
def test_threshold_for_fraction_matches(frac, stride):
    """The calibrated fg threshold (``ops/calibrate.py``): the same bin
    from the same exact counts and float32 fractions."""
    from tpuseg.ops.calibrate import threshold_for_fraction as ref_thr
    from tpuseg_torch.ops.calibrate import threshold_for_fraction

    fg, _ = _maps(seed=4)
    got = threshold_for_fraction(_t(fg), frac, sample_stride=stride)
    want = ref_thr(jnp.asarray(fg), frac, sample_stride=stride)
    assert float(got) == float(want)


def test_calibration_helpers_match():
    from tpuseg.ops import calibrate as ref
    from tpuseg_torch.ops import calibrate

    h = np.random.default_rng(0).uniform(1, 6, (20, 3)).astype(np.float32)
    h[:, 0] *= 0.4
    valid = np.arange(20) % 3 != 0
    assert calibrate.expected_fg_fraction(h, 10 ** 6, valid) == \
        ref.expected_fg_fraction(h, 10 ** 6, valid)
    assert calibrate.nms_radius_from_half_sizes(h) == \
        ref.nms_radius_from_half_sizes(h)
    for f in (1e-4, 0.01, 0.2):
        assert calibrate.adaptive_upper_pct(f) == ref.adaptive_upper_pct(f)
