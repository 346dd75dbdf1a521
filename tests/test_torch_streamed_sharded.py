"""The port's streamed x sharded composition (``stream_infer(mesh=...)``:
each z-chunk split over y) == the port's single-device stream == the JAX
package's sharded stream (``tests/distributed/test_streamed_sharded.py``,
each case under its name), with the y-shards on ``[cpu] * n`` and the JAX
package's on the virtual CPU devices of ``tests/conftest.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tpuseg.core import Config, InferConfig, PostprocConfig
from tpuseg.data import synthesize_volume
from tpuseg.data.normalize import percentile_normalize
from tpuseg.infer import stream_infer as ref_stream_infer
from tpuseg_torch.infer import make_infer_fn, stream_infer
from tpuseg_torch.parallel import Mesh

from chip_smoke import AnalyticNet
from test_torch_model import port_config, single_torch_thread  # noqa: F401
from test_torch_pipeline import RefAnalyticNet


@pytest.fixture(scope="module")
def cfg():
    return Config(
        infer=InferConfig(tile=(8, 32, 32), halo=4, compute_dtype="float32",
                          shard_halo=8, shard_max_labels=256),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16),
    )


@pytest.fixture(scope="module")
def volume():
    # y = 64: eight y-slabs of 8, narrower than the blobs, so instances
    # cross y boundaries
    return synthesize_volume(shape=(48, 64, 32), num_instances=10,
                             radius_range=(3.0, 5.0), noise=0.0, seed=4)


@pytest.fixture(scope="module")
def normalized(volume):
    return np.asarray(percentile_normalize(volume.image))


def y_mesh(n=8):
    return Mesh([torch.device("cpu")] * n, ("y",))


def _stream(cfg, vol, mesh=None, **kw):
    kw = {"chunk_z": 16, "halo": 8, "normalize": False, **kw}
    return stream_infer(AnalyticNet(), port_config(cfg), vol, device="cpu",
                        mesh=mesh, **kw)


def _ref_stream(cfg, vol, n=8, **kw):
    kw = {"chunk_z": 16, "halo": 8, "normalize": False, **kw}
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("y",))
    return ref_stream_infer(RefAnalyticNet(), cfg, {"params": {}}, vol,
                            mesh=mesh, **kw)


def _with(cfg, **postproc):
    return dataclasses.replace(cfg, postproc=dataclasses.replace(
        cfg.postproc, **postproc))


@pytest.fixture(scope="module")
def y8(cfg, normalized):
    return _stream(cfg, normalized, y_mesh())


def test_streamed_sharded_equals_streamed_single(cfg, normalized, y8):
    want = _stream(cfg, normalized)
    assert want.max() >= 8
    np.testing.assert_array_equal(y8, want)
    one = make_infer_fn(AnalyticNet(), port_config(cfg), False)(
        torch.from_numpy(normalized.copy())).numpy()
    np.testing.assert_array_equal(y8, one)
    np.testing.assert_array_equal(y8, _ref_stream(cfg, normalized))


def test_streamed_sharded_instances_cross_y_boundaries(y8):
    crossing = 0
    for lbl in np.unique(y8[y8 > 0]):
        ys = np.argwhere(y8 == lbl)[:, 1]
        crossing += (ys // 8).min() != (ys // 8).max()
    assert crossing >= 2, f"only {crossing} y-boundary-crossing instances"


def test_streamed_sharded_with_normalize_and_calibration(cfg, volume):
    c = _with(cfg, fg_target_fraction=0.05)
    raw = (volume.image * 900.0 + 100.0).astype(np.float32)
    stats = {}
    got = _stream(c, raw, y_mesh(), normalize=True, stats=stats)
    np.testing.assert_array_equal(got, _stream(c, raw, normalize=True))
    np.testing.assert_array_equal(got, _ref_stream(c, raw, normalize=True))
    assert 0.0 < stats["fg_threshold"] < 1.0


def test_streamed_sharded_two_shards_uneven_chunks(cfg, normalized):
    got = _stream(cfg, normalized, y_mesh(2), chunk_z=20)
    np.testing.assert_array_equal(got, _stream(cfg, normalized, chunk_z=20))
    np.testing.assert_array_equal(got, _ref_stream(cfg, normalized, n=2,
                                                   chunk_z=20))


def _touching_pairs():
    """Pairs of touching blobs 4 voxels apart (two seeds at NMS radius 2)
    whose saddle passes 0.8 of their peaks, pairs across the y boundaries
    of four shards and one across the z seam: merging changes the
    labels."""
    shape = (32, 32, 24)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij")
    img = np.zeros(shape, np.float32)
    for z, y in ((8, 8), (15, 24), (24, 16), (26, 29)):
        for dy in (-2, 2):
            d2 = (zz - z) ** 2 + (yy - y - dy) ** 2 + (xx - 12) ** 2
            img = np.maximum(img, np.exp(-0.5 * d2 / 12.0))
    return img.astype(np.float32)


@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_streamed_sharded_saddle_merge_equals_streamed_single(cfg, ratio):
    """The saddle merge in the sharded chunks (each y-shard's edges in
    chunk ids, closed on the host with the z seams) == the single-device
    stream, whose merge changes the labels here, == the JAX package's
    sharded stream (which merges each y-slab on the device)."""
    v = _touching_pairs()
    c = _with(cfg, merge_saddle_ratio=ratio, min_size=1)
    want = _stream(c, v)
    assert want.max() < _stream(cfg, v).max()
    got = _stream(c, v, y_mesh(4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref_stream(c, v, n=4))


def test_streamed_sharded_saddle_merge_dense_stack():
    """A dense stack (a (32, 128, 128) crop of 500 nuclei in 48x128x256) at
    merge 0.8, 4 y-shards of 32 rows, shard halo 8: a chain of merges
    reaches a y-window's edge, where a shard sees basins cut off. Edges
    taken from each shard's whole window (truncated basins included)
    change 1243 voxels here; the shards' own faces on the reconciled
    labels give the single-device stream's labels, the port's and the JAX
    package's. (The JAX package's sharded stream, which merges each
    y-slab before reconciling, differs from its single-device stream
    here.)"""
    from tpuseg_torch.data.normalize import histogram_percentile_normalize

    sv = synthesize_volume(shape=(48, 128, 256), num_instances=500, seed=2)
    v = histogram_percentile_normalize(torch.from_numpy(sv.image)[None])[0]
    v = np.ascontiguousarray(v.numpy()[:32, :, 128:])
    cfg = Config(infer=InferConfig(tile=(32, 128, 128), halo=0,
                                   compute_dtype="float32", shard_halo=8),
                 postproc=PostprocConfig(merge_saddle_ratio=0.8))
    want = _stream(cfg, v)
    assert want.max() >= 150
    np.testing.assert_array_equal(_stream(cfg, v, y_mesh(4)), want)
    np.testing.assert_array_equal(
        want, ref_stream_infer(RefAnalyticNet(), cfg, {"params": {}}, v,
                               chunk_z=16, halo=8, normalize=False))


def tall_pair() -> np.ndarray:
    """A (16, 64, 8) image in [0, 1] for AnalyticNet: an instance A over y
    2..40 whose one root sits at y 6, 26 rows before the seam (y 32) of
    two y-shards at shard halo 8, so the second shard sees A only from row
    24 on and roots its part there; beside it, across a valley at y 40|41,
    a basin B with its own peak at y 44. At merge ratio 0.35 A and B stay
    apart when A's maximum is read at its root (peak 0.777), and would
    merge if it were read at row 24 (0.562)."""
    y = np.arange(64)
    prof = np.where(y < 6, 0.80 - 0.01 * (6 - y), 0.80 - 0.04 / 18 * (y - 6))
    prof = np.where((y >= 2) & (y <= 40), prof, 0.0).astype(np.float32)
    prof[41:51] = [0.70, 0.74, 0.78, 0.82, 0.78, 0.74, 0.70, 0.6, 0.5, 0.4]
    v = np.zeros((16, 64, 8), np.float32)
    v[1:3, :, 2:6] = prof[None, :, None]
    return v


def test_streamed_sharded_merge_reads_far_roots(cfg):
    """A merge test whose basin's root lies more than the shard halo from
    the seam (``tall_pair``): the sharded stream reads the basin's maximum
    at its root, as the single-device stream does, and gives its labels."""
    v = tall_pair()
    c = _with(cfg, merge_saddle_ratio=0.35)
    want = _stream(c, v)
    assert want.max() == 2
    np.testing.assert_array_equal(_stream(c, v, y_mesh(2)), want)


def test_streamed_sharded_reports_overflow_and_truncation(cfg, normalized,
                                                          capsys):
    """A chunk's table past ``shard_max_labels`` prints the JAX package's
    report; a capped flood is counted over the shards (zero iff
    converged)."""
    c = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, shard_max_labels=1))
    _stream(c, normalized, y_mesh(2))
    assert "sharded-chunk label table OVERFLOW" in capsys.readouterr().out
    for iters, truncated in ((1, True), (64, False)):
        stats = {}
        _stream(_with(cfg, flood_iters=iters), normalized, y_mesh(2),
                stats=stats)
        assert (stats.get("flood_truncated_voxels", 0) > 0) == truncated


def test_streamed_sharded_mesh_checks(cfg, normalized):
    with pytest.raises(ValueError, match="must divide"):
        _stream(cfg, normalized, y_mesh(5))
    with pytest.raises(ValueError, match="one axis"):
        _stream(cfg, normalized, Mesh([torch.device("cpu")] * 4, ("z", "y"),
                                      (2, 2)))
