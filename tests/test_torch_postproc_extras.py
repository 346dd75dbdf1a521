"""The port's instance sizes, size filter, seed bound, seed labels and the
XLA resolve of the watershed (``tpuseg_torch/ops/filter.py``, ``peaks.py``,
``watershed.py`` with ``resolve_impl="xla"``) == the JAX package's on the
same numpy inputs. Every output is an integer volume or count and is
compared elementwise: both sides compute it from identical float32 maps
with the same float32 comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import Config, InferConfig, PostprocConfig
from tpuseg.infer import make_infer_fn as ref_make_infer_fn
from tpuseg.ops.filter import label_sizes as ref_label_sizes
from tpuseg.ops.filter import max_seed_count as ref_max_seed_count
from tpuseg.ops.filter import size_filter as ref_size_filter
from tpuseg.ops.peaks import seed_labels_from_peaks as ref_seed_labels
from tpuseg.ops.watershed import ascent_labels as ref_ascent_labels
from tpuseg.ops.watershed import watershed as ref_watershed
from tpuseg_torch.data import synthesize_touching_volume
from tpuseg_torch.infer import make_infer_fn
from tpuseg_torch.ops import (ascent_labels, label_sizes, max_seed_count,
                              seed_labels_from_peaks, size_filter, watershed)

from chip_smoke import AnalyticNet
from test_torch_model import port_config, single_torch_thread  # noqa: F401
from test_torch_ops import _maps, _t
from test_torch_pipeline import RefAnalyticNet


def _labels(seed=0, shape=(10, 14, 18)):
    """Root-index style labels: a few blocks of sizes 1..~300, each labelled
    by a voxel's linear index + 1, on a background of 0."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    lab = np.zeros(shape, np.int32)
    for _ in range(12):
        lo = [int(rng.integers(0, s)) for s in shape]
        ext = [int(rng.integers(1, 7)) for _ in shape]
        lab[tuple(slice(a, a + e) for a, e in zip(lo, ext))] = \
            int(rng.integers(1, n + 1))
    return lab


@pytest.mark.parametrize("seed", [0, 1])
def test_label_sizes_and_size_filter_match(seed):
    lab = _labels(seed)
    got = label_sizes(_t(lab))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_label_sizes(jnp.asarray(lab))))
    for min_size in (1, 9, 40):
        want = np.asarray(ref_size_filter(jnp.asarray(lab), min_size))
        np.testing.assert_array_equal(size_filter(_t(lab), min_size).numpy(),
                                      want)
    assert 0 < (want > 0).sum() < (lab > 0).sum()


@pytest.mark.parametrize("shape,radius", [((12, 20, 24), 2),
                                          ((7, 33, 40), (1, 2, 3)),
                                          ((5, 5, 5), 0)])
def test_max_seed_count_matches(shape, radius):
    assert max_seed_count(shape, radius) == ref_max_seed_count(shape, radius)


@pytest.mark.parametrize("nms_impl", ["xla", "pallas"])
@pytest.mark.parametrize("radius", [2, (1, 2, 2)])
def test_seed_labels_from_peaks_match(nms_impl, radius):
    """The reference always runs its XLA NMS; the port's K5 wrapper takes
    the same (plain) NMS on a CPU tensor."""
    _, peak = _maps(5)
    want = np.asarray(ref_seed_labels(jnp.asarray(peak), 0.5, radius))
    got = seed_labels_from_peaks(_t(peak), 0.5, radius, nms_impl=nms_impl)
    assert got.dtype == torch.int32 and want.max() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def _long_chain_maps(shape=(6, 24, 64), seed=3):
    """A potential rising slowly along x (ascent chains of ~60 voxels) with
    a few seeds: 2 or 3 pointer-jump rounds stop short of the roots."""
    rng = np.random.default_rng(seed)
    x = np.arange(shape[2], dtype=np.float32)
    ramp = np.broadcast_to(x / shape[2], shape).copy()
    peak = (0.5 * ramp + 0.01 * rng.random(shape)).astype(np.float32)
    fg = np.full(shape, 0.9, np.float32)
    fg[:, :, :3] = 0.1
    return fg, peak


@pytest.mark.parametrize("rounds", [None, 2, 3, 8])
def test_ascent_labels_match_including_unconverged(rounds):
    fg, peak = _long_chain_maps()
    fgm = fg >= 0.5
    seeds = peak >= np.quantile(peak, 0.995)
    want = np.asarray(ref_ascent_labels(jnp.asarray(peak), jnp.asarray(fgm),
                                        jnp.asarray(seeds), rounds=rounds))
    got = ascent_labels(_t(peak), _t(fgm), _t(seeds), rounds=rounds)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["ascent", "flood"])
@pytest.mark.parametrize("rounds,nms_impl", [(None, "xla"), (8, "xla"),
                                             (2, "xla"), (2, "pallas")])
@pytest.mark.parametrize("maps", ["blobs", "long_chains"])
def test_watershed_xla_resolve_matches(method, rounds, nms_impl, maps):
    """``resolve_impl="xla"`` == the JAX package's XLA composition (its
    default on the CPU), including ``ascent_rounds`` that stop the
    pointer jump short of the roots (checked to change the labels on the
    long chains)."""
    fg, peak = _maps(3, (16, 32, 40)) if maps == "blobs" \
        else _long_chain_maps()
    kw = dict(peak_threshold=0.45, fg_threshold=0.4, peak_radius=(1, 2, 2),
              flood_iters=48, method=method, ascent_rounds=rounds)
    want = np.asarray(ref_watershed(jnp.asarray(fg), jnp.asarray(peak),
                                    resolve_impl="xla", nms_impl=nms_impl,
                                    **kw))
    got = watershed(_t(fg), _t(peak), resolve_impl="xla", nms_impl=nms_impl,
                    **kw)
    assert got.dtype == torch.int32 and want.max() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    if method == "ascent" and maps == "long_chains" and rounds == 2:
        converged = watershed(_t(fg), _t(peak), resolve_impl="xla",
                              **{**kw, "ascent_rounds": None})
        assert not torch.equal(got, converged)


@pytest.mark.parametrize("touch_factor", [0.6, 0.5])
def test_pipeline_xla_resolve_matches_reference_default(touch_factor):
    """``make_infer_fn`` with ``postproc.resolve_impl="xla"`` == the JAX
    pipeline under its CPU default (``"auto"``, which is the XLA
    composition off the TPU) on a touching fixture, AnalyticNet logits."""
    tv = synthesize_touching_volume(shape=(16, 40, 48), num_pairs=6,
                                    num_singles=3, radius_range=(3.0, 5.0),
                                    touch_factor=touch_factor, seed=2)
    cfg = Config(infer=InferConfig(tile=(8, 24, 48), halo=2,
                                   compute_dtype="float32"),
                 postproc=PostprocConfig(min_size=5, flood_iters=24,
                                         ascent_rounds=3))
    want = np.asarray(ref_make_infer_fn(RefAnalyticNet(), cfg)(
        {"params": {}}, jnp.asarray(tv.image)))
    port_cfg = port_config(cfg).override(**{"postproc.resolve_impl": "xla"})
    got = make_infer_fn(AnalyticNet(), port_cfg)(torch.from_numpy(tv.image))
    assert want.max() >= 8
    np.testing.assert_array_equal(got.numpy(), want)
