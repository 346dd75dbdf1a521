"""The port's streamed inference (``tpuseg_torch/infer/streaming.py``) ==
``tpuseg.infer.stream_infer`` on the same inputs, and == the port's one-shot
``make_infer_fn`` where the JAX package's own tests assert that
(``tests/unit/test_streaming.py``, each case ported here under its name).

AnalyticNet (receptive field 0), (64, 32, 32), ``chunk_z`` 16, halo 8. Each
reference output is computed once per module (``ref``) to keep the JAX
package's chunk programs from compiling twice."""

import dataclasses

import numpy as np
import pytest
import torch

from tpuseg.core import Config, InferConfig, PostprocConfig
from tpuseg.data import synthesize_volume
from tpuseg.data.normalize import percentile_normalize
from tpuseg.infer import stream_infer as ref_stream_infer
from tpuseg_torch.infer import make_infer_fn, stream_infer

from chip_smoke import AnalyticNet
from test_torch_model import port_config, single_torch_thread  # noqa: F401
from test_torch_pipeline import RefAnalyticNet


@pytest.fixture(scope="module")
def cfg():
    return Config(
        infer=InferConfig(tile=(8, 32, 32), halo=4, compute_dtype="float32",
                          shard_halo=8),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16),
    )


@pytest.fixture(scope="module")
def volume():
    return synthesize_volume(shape=(64, 32, 32), num_instances=8,
                             radius_range=(3.0, 5.0), noise=0.0, seed=4)


@pytest.fixture(scope="module")
def normalized(volume):
    return np.asarray(percentile_normalize(volume.image))


@pytest.fixture(scope="module")
def raw(volume):
    return (volume.image * 900.0 + 100.0).astype(np.float32)


def _with(cfg, **postproc):
    return dataclasses.replace(cfg, postproc=dataclasses.replace(
        cfg.postproc, **postproc))


@pytest.fixture(scope="module")
def ref():
    """``ref(key, cfg, volume, **kw)``: the JAX package's streamed labels,
    computed once per key."""
    cache = {}

    def get(key, cfg, vol, **kw):
        if key not in cache:
            cache[key] = ref_stream_infer(RefAnalyticNet(), cfg,
                                          {"params": {}}, vol, **kw)
        return cache[key]

    return get


def _stream(cfg, vol, **kw):
    kw = {"chunk_z": 16, "halo": 8, "normalize": False, **kw}
    return stream_infer(AnalyticNet(), port_config(cfg), vol, device="cpu",
                        **kw)


def _one_shot(cfg, vol, normalize=False):
    return make_infer_fn(AnalyticNet(), port_config(cfg), normalize)(
        torch.from_numpy(np.array(vol))).numpy()


def test_stream_equals_single_shot(cfg, normalized, ref):
    want = _one_shot(cfg, normalized)
    assert want.max() >= 6
    got = _stream(cfg, normalized)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref("plain", cfg, normalized, chunk_z=16, halo=8,
                 normalize=False))


def test_stream_reports_flood_truncation(cfg):
    """A flat tube seeded only at x = 0 relies on the absorb flood: 4 steps
    truncate it, 80 do not; counts equal the reference's."""
    v = np.zeros((16, 8, 64), np.float32)
    v[2, 2, :] = 0.5
    v[2, 2, 0] = 1.0
    for iters, truncated in ((4, True), (80, False)):
        c = _with(cfg, flood_iters=iters, min_size=1)
        stats, ref_stats = {}, {}
        got = _stream(c, v, chunk_z=8, halo=4, stats=stats)
        want = ref_stream_infer(RefAnalyticNet(), c, {"params": {}}, v,
                                chunk_z=8, halo=4, normalize=False,
                                stats=ref_stats)
        np.testing.assert_array_equal(got, want)
        n = stats.get("flood_truncated_voxels", 0)
        assert (n > 0) == truncated
        assert n == ref_stats.get("flood_truncated_voxels", 0)


def test_stream_with_normalization_close(cfg, raw, ref):
    want = _one_shot(cfg, raw, normalize=True)
    got = _stream(cfg, raw, normalize=True)
    assert (got == want).mean() > 0.999
    np.testing.assert_array_equal(
        got, ref("norm", cfg, raw, chunk_z=16, halo=8, normalize=True))


def test_stream_uneven_last_chunk(cfg, normalized, ref):
    """D = 64, chunk_z = 24: chunks 24 / 24 / 16, the padding path."""
    got = _stream(cfg, normalized, chunk_z=24)
    np.testing.assert_array_equal(got, _one_shot(cfg, normalized))
    np.testing.assert_array_equal(
        got, ref("uneven", cfg, normalized, chunk_z=24, halo=8,
                 normalize=False))


def test_stream_into_preallocated_out(cfg, normalized, ref):
    out = np.zeros(normalized.shape, np.int32)
    got = _stream(cfg, normalized, out=out)
    assert got is out
    assert out.max() >= 6
    np.testing.assert_array_equal(
        out, ref("plain", cfg, normalized, chunk_z=16, halo=8,
                 normalize=False))


def test_stream_calibrated_threshold_equals_single(cfg, normalized, ref):
    """``fg_target_fraction`` (pass 1b): streamed == one-shot == the
    reference's stream."""
    c = _with(cfg, fg_target_fraction=0.05)
    got = _stream(c, normalized)
    np.testing.assert_array_equal(got, _one_shot(c, normalized))
    np.testing.assert_array_equal(
        got, ref("calib", c, normalized, chunk_z=16, halo=8,
                 normalize=False))


def test_stream_preserves_integer_source_dtype(cfg, normalized, ref):
    """uint16 uploads as uint16 (cast on the device) and gives the labels of
    a float32 source of the same values."""
    v16 = (normalized * 65535).astype(np.uint16)
    a = _stream(cfg, v16.astype(np.float32), normalize=True)
    b = _stream(cfg, v16, normalize=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        b, ref("u16", cfg, v16, chunk_z=16, halo=8, normalize=True))


class _Boom(Exception):
    pass


def test_stream_kill_and_resume_exact(cfg, normalized, tmp_path):
    """Killed after chunk 1 and restarted with the same ``resume_dir`` and
    ``out``: resumes at the first unfinished chunk, same labels."""
    want = _stream(cfg, normalized)
    rdir = str(tmp_path / "resume")
    out = np.zeros(normalized.shape, np.int32)

    def killer(ci):
        if ci >= 1:
            raise _Boom()

    with pytest.raises(_Boom):
        _stream(cfg, normalized, out=out, resume_dir=rdir,
                on_chunk_done=killer)
    calls = []
    got = _stream(cfg, normalized, out=out, resume_dir=rdir,
                  on_chunk_done=calls.append)
    assert calls and calls[0] == 2, calls
    np.testing.assert_array_equal(got, want)


def test_stream_resume_reuses_calibration_scalars(cfg, raw, ref, tmp_path):
    """The resumed run reloads the normalization and threshold scalars and
    matches the uninterrupted run and the reference's."""
    c = _with(cfg, fg_target_fraction=0.05)
    rdir = str(tmp_path / "resume")
    out = np.zeros(raw.shape, np.int32)

    def killer(ci):
        raise _Boom()

    with pytest.raises(_Boom):
        _stream(c, raw, normalize=True, out=out, resume_dir=rdir,
                on_chunk_done=killer)
    got = _stream(c, raw, normalize=True, out=out, resume_dir=rdir)
    np.testing.assert_array_equal(got, _stream(c, raw, normalize=True))
    np.testing.assert_array_equal(
        got, ref("norm_calib", c, raw, chunk_z=16, halo=8, normalize=True))


def test_stream_resume_geometry_mismatch_restarts(cfg, normalized, tmp_path):
    """A ``resume_dir`` written under other chunking is emptied, not mixed
    in."""
    rdir = str(tmp_path / "resume")
    first = _stream(cfg, normalized, resume_dir=rdir)
    calls = []
    second = _stream(cfg, normalized, chunk_z=24, resume_dir=rdir,
                     on_chunk_done=calls.append)
    assert calls[0] == 0
    np.testing.assert_array_equal(first, second)


class _CountingVolume:
    """Array-like wrapper counting the voxels read through ``__getitem__``."""

    def __init__(self, arr):
        self._arr = arr
        self.voxels_read = 0

    @property
    def shape(self):
        return self._arr.shape

    @property
    def dtype(self):
        return self._arr.dtype

    def __getitem__(self, key):
        out = self._arr[key]
        self.voxels_read += out.size
        return out


def test_stream_normalization_is_one_source_pass(cfg, raw, ref):
    counted = _CountingVolume(raw)
    got = _stream(cfg, counted, normalize=True)
    d, h, w = raw.shape
    core = d * h * w
    chunk_pass = core + -(-d // 16) * 2 * 8 * h * w   # ext over-read, halo 8
    assert counted.voxels_read <= core + chunk_pass
    np.testing.assert_array_equal(
        got, ref("norm", cfg, raw, chunk_z=16, halo=8, normalize=True))


def test_stream_normalization_spill_path_identical(cfg, volume):
    """Spilling the sample to disk changes nothing."""
    raw = (volume.image * 77.0 + 5.0).astype(np.float32)
    a = _stream(cfg, raw, normalize=True)
    b = _stream(cfg, raw, normalize=True, sample_cache_bytes=0)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        b, ref_stream_infer(RefAnalyticNet(), cfg, {"params": {}}, raw,
                            chunk_z=16, halo=8, normalize=True,
                            sample_cache_bytes=0))


def test_stream_with_saddle_merge_equals_fused(cfg, normalized, ref):
    """``merge_saddle_ratio`` engaged: streamed == one-shot == reference."""
    c = _with(cfg, merge_saddle_ratio=0.5, merge_max_pairs=1024)
    got = _stream(c, normalized)
    np.testing.assert_array_equal(got, _one_shot(c, normalized))
    np.testing.assert_array_equal(
        got, ref("merge", c, normalized, chunk_z=16, halo=8,
                 normalize=False))


def test_stream_nms_pallas_equals_default(cfg, normalized, ref):
    """``postproc.nms_impl="pallas"`` (K5's composition; its twin here)
    gives the default path's streamed labels."""
    got = _stream(_with(cfg, nms_impl="pallas"), normalized)
    np.testing.assert_array_equal(
        got, ref("plain", cfg, normalized, chunk_z=16, halo=8,
                 normalize=False))


def test_stream_bfloat16_equals_reference(cfg, normalized, ref):
    """In bf16 the streamed chunk takes its sigmoid in float32 (the one-shot
    path takes it in the compute dtype, in both packages): the port's
    stream equals the JAX package's stream there too."""
    c = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, compute_dtype="bfloat16"))
    got = _stream(c, normalized)
    assert got.max() >= 6
    np.testing.assert_array_equal(
        got, ref("bf16", c, normalized, chunk_z=16, halo=8, normalize=False))


def test_stream_mesh_raises(cfg, normalized):
    """``mesh=`` is ported (``tests/test_torch_streamed_sharded.py``); a
    mesh that cannot split the chunks over y still raises."""
    from tpuseg_torch.parallel import Mesh

    with pytest.raises(ValueError, match="must divide"):
        _stream(cfg, normalized, mesh=Mesh(["cpu"] * 3, ("y",)))
    with pytest.raises(ValueError, match="one axis"):
        _stream(cfg, normalized, mesh=Mesh(["cpu"] * 4, ("z", "y"), (2, 2)))


def test_stream_resumed_truncation_count_is_whole_volume(cfg, normalized,
                                                         tmp_path):
    """The flood-truncation count after a resume includes the chunks that
    finished before the kill (each chunk's count is kept in its
    ``chunk_*.npz``)."""
    c = _with(cfg, flood_iters=1)
    want = {}
    _stream(c, normalized, stats=want)
    assert want["flood_truncated_voxels"] > 0
    rdir = str(tmp_path / "resume")
    out = np.zeros(normalized.shape, np.int32)

    def killer(ci):
        if ci >= 1:
            raise _Boom()

    with pytest.raises(_Boom):
        _stream(c, normalized, out=out, resume_dir=rdir, on_chunk_done=killer)
    stats = {}
    _stream(c, normalized, out=out, resume_dir=rdir, stats=stats)
    assert stats["flood_truncated_voxels"] == want["flood_truncated_voxels"]
    assert set(stats) >= {"t_normalize_pass", "t_calibrate_pass", "t_chunks",
                          "t_finalize"}


def _u_taller_than_the_halo():
    """One instance whose only seed is at z = 1: an arm down to z = 20, a
    bar along x there, and a second arm back up to z = 9, every voxel
    ascending towards the seed. The chunk below the seam at z = 16 sees the
    seed only with a halo of 15 planes or more."""
    v = np.zeros((48, 8, 16), np.float32)
    d = 0

    def put(z, x):
        nonlocal d
        v[z, 3, x] = 1.0 if d == 0 else 0.74 - 0.003 * d
        d += 1

    for z in range(1, 21):
        put(z, 3)
    for x in range(4, 13):
        put(20, x)
    for z in range(19, 8, -1):
        put(z, 12)
    v[0, 3, 3] = 0.74 - 0.003
    return v


@pytest.mark.parametrize("halo", [8, 16])
def test_stream_instance_taller_than_the_halo(cfg, halo):
    """Outside the halo contract the stream splits an instance at a seam as
    the JAX package's stream does: with halo 8 the chunk under the seam
    finds no seed, so the instance keeps only its two arms above the seam,
    in two pieces (``labels_are_connected`` fails on both packages'
    labels); with halo 16 both equal the one-shot path and are connected.
    This is what ``cli.infer --stream --validate`` reports on instances
    taller than ``infer.shard_halo``."""
    from tpuseg.ops.components import \
        labels_are_connected as ref_labels_are_connected
    from tpuseg_torch.ops import labels_are_connected

    v = _u_taller_than_the_halo()
    got = _stream(cfg, v, halo=halo)
    want = ref_stream_infer(RefAnalyticNet(), cfg, {"params": {}}, v,
                            chunk_z=16, halo=halo, normalize=False)
    np.testing.assert_array_equal(got, want)
    one = _one_shot(cfg, v)
    assert one.max() == 1 and labels_are_connected(one, device="cpu")
    if halo == 8:
        assert got.max() == 1 and (got[:16] == one[:16]).all()
        assert not got[16:].any()
        assert not labels_are_connected(got, device="cpu", chunk_z=16)
        assert not ref_labels_are_connected(want)
    else:
        np.testing.assert_array_equal(got, one)
        assert labels_are_connected(got, device="cpu", chunk_z=16)
