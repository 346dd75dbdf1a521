"""One-volume inference as one device program: the pieces that replaced the
port's host reads, held to the JAX package on the CPU.

The histograms of ``tpuseg_torch/ops/hist.py`` (H1 ``bin_counts``, H2
``percentiles``, H3 ``label_counts``) run here through their plain twins,
which are what the kernels are held to on the card (``chip_smoke.py``
phase 18): H1's twin under both bin rules equal to the reference's counts,
H2's twin (``percentiles_from_counts`` returns tensors now) bit-equal to
``tpuseg.data.histogram_percentile_scalars`` (above 2**24 samples too,
where one bin's count is not a float32 integer), the size filter through
H3's twin equal to ``tpuseg.ops.filter.size_filter_and_compact``, and the
watershed with 0-d tensor thresholds equal to the same float thresholds and
to the reference called with traced scalars. Counts and labels are
integers and the percentiles are compared bitwise: no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.data.normalize import histogram_percentile_scalars as ref_scalars
from tpuseg.ops.filter import size_filter_and_compact as ref_filter
from tpuseg.ops.histogram import bin_counts as ref_bin_counts
from tpuseg.ops.watershed import watershed as ref_watershed
from tpuseg_torch.data.normalize import (histogram_percentile_normalize,
                                         histogram_percentile_scalars,
                                         percentiles_from_counts)
from tpuseg_torch.ops import hist
from tpuseg_torch.ops.filter import label_sizes, size_filter_and_compact
from tpuseg_torch.ops.watershed import watershed

from test_torch_model import single_torch_thread  # noqa: F401
from test_torch_ops import _maps

BINS = 4096


def _ref_norm_counts(sample):
    """The reference's normalization histogram of one row."""
    s = jnp.asarray(sample, jnp.float32)
    lo = jnp.min(s)
    span = jnp.maximum(jnp.max(s) - lo, 1e-12)
    idx = jnp.clip(((s - lo) / span * BINS).astype(jnp.int32), 0, BINS - 1)
    return np.asarray(ref_bin_counts(idx, BINS)), lo, span


def _gamma_volume(shape, seed):
    rng = np.random.default_rng(seed)
    vol = (rng.gamma(2.0, 50.0, shape) + 7).astype(np.float32)
    vol[rng.random(shape) < 0.01] = 900.0
    return vol


# ----------------------------------------------------------- H1 bin_counts


@pytest.mark.parametrize("seed,shape", [(0, (3, 7, 11)), (1, (9, 20, 33)),
                                        (2, (1, 1, 1)), (3, (2, 64, 65))])
def test_bin_counts_normalize_rule_matches_reference(seed, shape):
    vol = _gamma_volume(shape, seed)
    want, lo, span = _ref_norm_counts(vol.reshape(-1))
    t = torch.from_numpy(vol.reshape(1, -1))
    got = hist.bin_counts(t, torch.tensor([float(lo)]),
                          torch.tensor([float(span)]), BINS)
    assert got.dtype == torch.int64 and got.shape == (1, BINS)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_bin_counts_rows_are_independent():
    """(B, n): each row between its own lo and span (the train step's
    per-patch histograms)."""
    vols = np.stack([_gamma_volume((4, 9, 13), s) * (1 + s) for s in range(3)])
    flat = torch.from_numpy(vols.reshape(3, -1))
    lo = flat.min(dim=1).values
    span = torch.clamp(flat.max(dim=1).values - lo, min=1e-12)
    got = hist.bin_counts(flat, lo, span, BINS)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      _ref_norm_counts(vols[i].reshape(-1))[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_counts_calibrate_rule_matches_reference(seed):
    rng = np.random.default_rng(seed)
    prob = rng.random((6, 17, 29)).astype(np.float32) ** 3
    prob[0, 0, :4] = [0.0, 1.0, np.float32(4095 / 4096), np.float32(1e-9)]
    idx = jnp.clip((jnp.asarray(prob) * BINS).astype(jnp.int32), 0, BINS - 1)
    want = np.asarray(ref_bin_counts(idx, BINS))
    got = hist.bin_counts(torch.from_numpy(prob.reshape(1, -1)), bins=BINS,
                          rule="calibrate")
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert int(got.sum()) == prob.size


def test_bin_counts_refuses_unknown_rule():
    with pytest.raises(ValueError, match="unknown bin rule"):
        hist.bin_counts(torch.zeros(1, 4), rule="bogus")


# ----------------------------------------------------------- H2 percentiles


@pytest.mark.parametrize("pcts", [(1.0, 99.8), (0.3, 50.0, 99.97)])
@pytest.mark.parametrize("shape", [(5, 7, 9), (16, 40, 52), (1, 3, 1)])
def test_percentiles_twin_bit_equal_on_ragged_volumes(shape, pcts):
    vol = _gamma_volume(shape, seed=sum(shape))
    counts, lo, span = _ref_norm_counts(vol.reshape(-1))
    got = percentiles_from_counts(
        torch.from_numpy(counts.astype(np.int64))[None], vol.size,
        torch.tensor([float(lo)]), torch.tensor([float(span)]), pcts, BINS)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == (len(pcts), 1)
    want = [ref_scalars(jnp.asarray(vol), (p, p))[0] for p in pcts]
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  np.asarray(want, np.float32))


def test_percentile_scalars_bit_equal_above_2_pow_24():
    """17.0M samples, 99% of them in one bin: its count (above 2**24) is
    not a float32 integer, so the CDF's first entry is rounded, and a
    percentile in the tail lands on the bin that rounding gives."""
    shape = (65, 512, 512)
    rng = np.random.default_rng(7)
    vol = np.zeros(shape, np.float32)
    tail = rng.random(shape) < 0.01
    vol[tail] = rng.gamma(2.0, 50.0, int(tail.sum())).astype(np.float32)
    assert vol.size > 2 ** 24 and (vol == 0).sum() > 2 ** 24
    pcts = (1.0, 99.3)
    got = histogram_percentile_scalars(torch.from_numpy(vol), pcts)
    want = ref_scalars(jnp.asarray(vol), pcts)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.dim() == 0
        assert np.float32(g) == np.float32(w)


def test_normalize_returns_device_tensors():
    """The scalars and the batch normalization keep the percentiles as
    tensors on the input's device (no host round trip)."""
    vol = torch.from_numpy(_gamma_volume((4, 8, 12), 5))
    p_lo, p_hi = histogram_percentile_scalars(vol)
    assert all(isinstance(p, torch.Tensor) and p.device == vol.device
               for p in (p_lo, p_hi))
    out = histogram_percentile_normalize(vol[None])
    assert out.shape == (1, 4, 8, 12) and float(out.max()) == 1.0


# ---------------------------------------------------- H3 and the size filter


def _index_labels(shape, seed, n_inst=12):
    """Root-index labels (lin + 1 of a voxel of the instance), instances
    of random sizes, background most of the volume."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    labels = np.zeros(n, np.int32)
    roots = rng.choice(n, n_inst, replace=False)
    for r in roots:
        size = int(rng.integers(1, 60))
        start = int(rng.integers(0, n - size))
        labels[start:start + size] = r + 1
    return labels.reshape(shape)


# 0 and -3 keep every instance (nothing validates min_size): only labels
# present are ranked, 1..K
@pytest.mark.parametrize("min_size", [1, 27, 10_000, 0, -3])
@pytest.mark.parametrize("seed", [0, 1])
def test_size_filter_and_compact_on_index_labels(seed, min_size):
    labels = _index_labels((10, 21, 30), seed)
    want = np.asarray(ref_filter(jnp.asarray(labels), min_size))
    got = size_filter_and_compact(torch.from_numpy(labels), min_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if min_size > labels.size:
        assert (want == 0).all()
    if min_size <= 1:
        assert got.max() == np.unique(labels).size - 1


def test_size_filter_and_compact_all_background():
    labels = np.zeros((4, 5, 6), np.int32)
    got = size_filter_and_compact(torch.from_numpy(labels), 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_filter(jnp.asarray(labels), 1)))
    assert (got == 0).all()


def test_label_counts_twin_skips_background():
    labels = _index_labels((6, 9, 11), 3)
    counts = hist.label_counts(torch.from_numpy(labels))
    assert counts.dtype == torch.int32 and counts.shape == (labels.size + 1,)
    want = np.bincount(labels.reshape(-1), minlength=labels.size + 1)
    want[0] = 0
    np.testing.assert_array_equal(counts.numpy(), want)
    # label_sizes puts the background's count back at label 0
    sizes = label_sizes(torch.from_numpy(labels)).numpy()
    assert (sizes[labels == 0] == (labels == 0).sum()).all()


# ------------------------------------------- watershed with tensor thresholds


@pytest.mark.parametrize("method,nms_impl", [("ascent", "xla"),
                                             ("ascent", "pallas"),
                                             ("flood", "xla")])
def test_watershed_tensor_thresholds(method, nms_impl):
    """0-d float32 tensors, as the calibrated threshold arrives, give the
    labels of the same float thresholds, and those of the reference with
    the thresholds traced."""
    fg_prob, peak = _maps(3, (16, 32, 40))
    kw = dict(peak_radius=(1, 2, 2), flood_iters=48, method=method,
              nms_impl=nms_impl)
    fg_t, pk_t = torch.from_numpy(fg_prob), torch.from_numpy(peak)
    with_floats = watershed(fg_t, pk_t, peak_threshold=0.5, fg_threshold=0.4,
                            **kw)
    with_tensors = watershed(fg_t, pk_t,
                             peak_threshold=torch.tensor(0.5),
                             fg_threshold=torch.tensor(np.float32(0.4)), **kw)
    assert torch.equal(with_floats, with_tensors)

    ref = jax.jit(lambda f, p, pt, ft: ref_watershed(
        f, p, peak_threshold=pt, fg_threshold=ft, ascent_rounds=None,
        peak_radius=(1, 2, 2), flood_iters=48, method=method))
    want = np.asarray(ref(jnp.asarray(fg_prob), jnp.asarray(peak),
                          jnp.float32(0.5), jnp.float32(0.4)))
    assert want.max() > 0
    np.testing.assert_array_equal(with_tensors.numpy(), want)


def test_tensor_threshold_compares_in_float32_on_bf16_maps():
    """bf16 maps (the one-shot path's bf16 sigmoid) and a 0-d float32
    threshold: the reference compares a traced threshold in float32, not in
    the map's dtype (as torch would round it), so the mask agrees with K1's
    own float32 compare and no foreground voxel is left unresolvable."""
    fg32, pk32 = _maps(5, (16, 32, 40))
    thr = np.float32(0.4009)      # above the bf16 level it rounds down to
    fg_bf = torch.from_numpy(fg32).to(torch.bfloat16)
    pk_bf = torch.from_numpy(pk32).to(torch.bfloat16)
    as_f32 = fg_bf.float() >= float(thr)
    assert (as_f32 != (fg_bf >= float(thr))).any()    # the case is real
    kw = dict(peak_radius=(1, 2, 2), flood_iters=48)
    got = watershed(fg_bf, pk_bf, peak_threshold=0.5,
                    fg_threshold=torch.tensor(thr), **kw)
    ref = jax.jit(lambda f, p, ft: ref_watershed(
        f, p, peak_threshold=0.5, fg_threshold=ft, ascent_rounds=None, **kw))
    want = np.asarray(ref(jnp.asarray(fg32).astype(jnp.bfloat16),
                          jnp.asarray(pk32).astype(jnp.bfloat16),
                          jnp.float32(thr)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((got.numpy() > 0) == as_f32.numpy()).all()
