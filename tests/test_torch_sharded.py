"""The port's sharded inference (``tpuseg_torch/infer/sharded.py``) ==
``tpuseg.infer.make_sharded_infer_fn`` on the same volume, and == the
port's one-shot ``make_infer_fn``: each case of
``tests/distributed/test_sharded_infer.py`` under its name.

The JAX package runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port puts its shards on ``[cpu] * 8``. AnalyticNet (receptive field 0)
keeps the equality to the halo contract under test; the real U-Net case
trains a small net once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from tpuseg.core import Config, InferConfig, PostprocConfig
from tpuseg.data import synthesize_volume
from tpuseg.data.normalize import percentile_normalize
from tpuseg.infer import make_infer_fn as ref_make_infer_fn
from tpuseg.infer import make_sharded_infer_fn as ref_make_sharded_infer_fn
from tpuseg.infer import make_z_mesh as ref_make_z_mesh
from tpuseg.infer import make_zy_mesh as ref_make_zy_mesh
from tpuseg.infer import shard_volume as ref_shard_volume
from tpuseg.infer.sharded import \
    global_histogram_percentile as ref_global_histogram_percentile
from tpuseg.parallel.halo import exchange_z_halo as ref_exchange_z_halo
from tpuseg.parallel.reconcile import (_closure_table as ref_closure_table,
                                       apply_label_map as ref_apply_label_map)
from tpuseg_torch.data.normalize import histogram_percentile_scalars
from tpuseg_torch.infer import (make_infer_fn, make_sharded_infer_fn,
                                make_z_mesh, make_zy_mesh, shard_volume,
                                unshard)
from tpuseg_torch.infer.sharded import (global_histogram_percentile,
                                        report_sharded_counts)
from tpuseg_torch.parallel import exchange_z_halo
from tpuseg_torch.parallel.reconcile import (SHARD_OVERFLOW, _closure_table,
                                             apply_label_map)

from chip_smoke import AnalyticNet
from test_torch_model import port_config, single_torch_thread  # noqa: F401
from test_torch_pipeline import RefAnalyticNet
from test_torch_streamed_sharded import tall_pair

CPU8 = [torch.device("cpu")] * 8


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
    return synthesize_volume(shape=(64, 32, 32), num_instances=8,
                             radius_range=(3.0, 5.0), noise=0.0, seed=4)


@pytest.fixture(scope="module")
def zy_volume():
    return synthesize_volume(shape=(32, 32, 32), num_instances=10,
                             radius_range=(3.0, 5.0), noise=0.0, seed=9)


def _mesh(shape):
    return (make_z_mesh(devices=CPU8) if shape is None
            else make_zy_mesh(shape, devices=CPU8))


def _sharded(cfg, vol, mesh_shape=None, normalize=False, z_offset=0,
             model=None):
    mesh = _mesh(mesh_shape)
    infer = make_sharded_infer_fn(model or AnalyticNet(), port_config(cfg),
                                  mesh, normalize=normalize)
    return unshard(infer(shard_volume(np.asarray(vol), mesh),
                         z_offset=z_offset), mesh)


def _one_shot(cfg, vol, normalize=False, model=None):
    return make_infer_fn(model or AnalyticNet(), port_config(cfg), normalize)(
        torch.from_numpy(np.array(vol))).numpy()


def _ref_sharded(cfg, vol, mesh_shape=None, normalize=False, model=None,
                 variables=None):
    mesh = ref_make_z_mesh() if mesh_shape is None \
        else ref_make_zy_mesh(mesh_shape)
    fn = ref_make_sharded_infer_fn(model or RefAnalyticNet(), cfg, mesh,
                                   normalize=normalize)
    return np.asarray(fn(variables or {"params": {}},
                         ref_shard_volume(jnp.asarray(vol), mesh)))


def _with(cfg, **postproc):
    return dataclasses.replace(cfg, postproc=dataclasses.replace(
        cfg.postproc, **postproc))


def test_halo_exchange_matches_padded():
    vol = np.random.default_rng(0).random((32, 8, 8)).astype(np.float32)
    slabs = [torch.from_numpy(vol[i * 4:(i + 1) * 4]) for i in range(8)]
    ext = [e.numpy() for e in exchange_z_halo(slabs, 2)]
    padded = np.pad(vol, ((2, 2), (0, 0), (0, 0)), mode="edge")
    for i in range(8):
        np.testing.assert_array_equal(ext[i], padded[i * 4:i * 4 + 8])
    mesh = ref_make_z_mesh()
    want = jax.jit(shard_map(lambda s: ref_exchange_z_halo(s, 2, "z"),
                             mesh=mesh, in_specs=P("z"), out_specs=P("z"),
                             check_rep=False))(
        ref_shard_volume(jnp.asarray(vol), mesh))
    np.testing.assert_array_equal(np.concatenate(ext), np.asarray(want))
    with pytest.raises(ValueError, match="exceeds the local slab extent"):
        exchange_z_halo(slabs, 5)


def test_closure_table_merges_chains():
    edges = [[5, 9], [9, 120], [7, 7], [0, 3], [40, 2]]
    lab = [[5, 9, 120, 7, 3, 40, 2, 1]]
    keys, reps = _closure_table(torch.tensor(edges, dtype=torch.int32))
    out = apply_label_map(torch.tensor(lab, dtype=torch.int32), keys,
                          reps).numpy()[0]
    assert out[0] == out[1] == out[2] == 5   # 5-9-120 chain -> 5
    assert out[3] == 7                        # self-edge no-op
    assert out[4] == 3                        # inactive edge (0) ignored
    assert out[5] == out[6] == 2              # 40-2 -> 2
    assert out[7] == 1                        # untouched label unchanged
    rk, rr = ref_closure_table(jnp.asarray(edges, jnp.int32))
    np.testing.assert_array_equal(
        out, np.asarray(ref_apply_label_map(jnp.asarray(lab, jnp.int32), rk,
                                            rr))[0])


@pytest.fixture(scope="module")
def normalized(volume):
    return np.asarray(percentile_normalize(volume.image))


@pytest.fixture(scope="module")
def z8(cfg, normalized):
    """(port sharded, port one-shot, the JAX package's sharded) on z8."""
    return (_sharded(cfg, normalized), _one_shot(cfg, normalized),
            _ref_sharded(cfg, normalized))


def test_sharded_equals_single_device(z8):
    got, one, ref = z8
    assert one.max() >= 6
    assert got.shape == one.shape
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, ref)


def test_sharded_instances_cross_boundaries(z8):
    """At least two instances span a z boundary (slab depth 8)."""
    got = z8[0]
    crossing = 0
    for lbl in np.unique(got[got > 0]):
        zs = np.argwhere(got == lbl)[:, 0]
        crossing += (zs // 8).min() != (zs // 8).max()
    assert crossing >= 2, f"only {crossing} boundary-crossing instances"


def _ref_scalars(cfg, raw):
    """The JAX package's sharded percentile scalars (float32 fractions)."""
    mesh = ref_make_z_mesh()
    fn = shard_map(lambda s: jnp.stack(ref_global_histogram_percentile(
        s, cfg.data.normalize_pcts, "z",
        sample_stride=cfg.data.normalize_sample_stride)),
        mesh=mesh, in_specs=P("z"), out_specs=P(), check_rep=False)
    return np.asarray(jax.jit(fn)(ref_shard_volume(jnp.asarray(raw), mesh)))


def test_sharded_normalization_close_to_exact(cfg, volume):
    """With int64 counts the sharded scalars equal the one-shot's exactly,
    and so do the labels. The JAX package's sharded scalars sum float32
    fractions and may land bins away in a sparse tail; its labels are held
    to its own test's agreement."""
    raw = (volume.image * 900.0 + 100.0).astype(np.float32)
    slabs = shard_volume(raw, make_z_mesh(devices=CPU8))
    got_s = [float(v) for v in global_histogram_percentile(
        slabs, cfg.data.normalize_pcts)]
    one_s = [float(v) for v in histogram_percentile_scalars(
        torch.from_numpy(raw), cfg.data.normalize_pcts)]
    assert got_s == one_s
    got = _sharded(cfg, raw, normalize=True)
    np.testing.assert_array_equal(got, _one_shot(cfg, raw, normalize=True))
    want = _ref_sharded(cfg, raw, normalize=True)
    agree = (got == want).mean()
    assert agree > 0.999, (agree, got_s, _ref_scalars(cfg, raw))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_sharded_2d_zy_equals_single_device(cfg, zy_volume, mesh_shape):
    """A (z, y) mesh: instances crossing z boundaries, y boundaries and
    corners (merged transitively through one closure)."""
    v = np.asarray(percentile_normalize(zy_volume.image))
    one = _one_shot(cfg, v)
    assert one.max() >= 6
    got = _sharded(cfg, v, mesh_shape)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, _ref_sharded(cfg, v, mesh_shape))
    hl = 32 // mesh_shape[1]
    crossing_y = 0
    for lbl in np.unique(got[got > 0]):
        ys = np.argwhere(got == lbl)[:, 1]
        crossing_y += (ys // hl).min() != (ys // hl).max()
    assert crossing_y >= 2, f"only {crossing_y} y-boundary-crossing instances"


def test_sharded_2d_corner_crossing_instance(cfg):
    """An instance centred on a (z, y) shard corner spans four shards; z
    and y edges close it into one label."""
    shape = (32, 32, 32)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij")
    img = np.zeros(shape, np.float32)
    for c in [(16.0, 16.0, 16.0), (16.0, 8.0, 24.0), (8.0, 24.0, 8.0)]:
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        img = np.maximum(img, np.exp(-0.5 * d2 / 9.0).astype(np.float32))
    got = _sharded(cfg, img, (2, 4))
    np.testing.assert_array_equal(got, _one_shot(cfg, img))
    np.testing.assert_array_equal(got, _ref_sharded(cfg, img, (2, 4)))
    corner_label = got[16, 16, 16]
    assert corner_label > 0
    quads = {(z // 16, y // 16)
             for z, y, x in np.argwhere(got == corner_label)}
    assert quads == {(0, 0), (0, 1), (1, 0), (1, 1)}, quads


@pytest.mark.parametrize("mesh_shape", [(2, 4)])
def test_sharded_2d_normalize_and_calibration(cfg, zy_volume, mesh_shape):
    c = _with(cfg, fg_target_fraction=0.03)
    raw = (zy_volume.image * 900.0 + 100.0).astype(np.float32)
    got = _sharded(c, raw, mesh_shape, normalize=True)
    np.testing.assert_array_equal(got, _one_shot(c, raw, normalize=True))
    want = _ref_sharded(c, raw, mesh_shape, normalize=True)
    agree = (got == want).mean()
    assert agree > 0.999, agree


def test_sharded_calibrated_threshold_equals_single(cfg, normalized):
    """The summed core histograms give the one-shot threshold exactly."""
    c = _with(cfg, fg_target_fraction=0.03)
    got = _sharded(c, normalized)
    np.testing.assert_array_equal(got, _one_shot(c, normalized))
    np.testing.assert_array_equal(got, _ref_sharded(c, normalized))


def test_sharded_z_offset_beyond_int32(cfg, normalized, z8):
    """The same block at z_offset 3e6 (linear indices ~3.2e9 > 2^31): the
    same labels; the port orders by int64 coordinates."""
    far = _sharded(cfg, normalized, z_offset=3_000_000)
    assert z8[0].max() >= 6
    np.testing.assert_array_equal(far, z8[0])


def test_sharded_merge_and_pallas_nms_equal_single_device(cfg, normalized):
    """The saddle merge (on the reconciled basins) and
    ``nms_impl="pallas"`` (K5's twin here) give the one-shot labels and the
    JAX package's sharded ones."""
    for post in ({"merge_saddle_ratio": 0.5}, {"nms_impl": "pallas"}):
        c = _with(cfg, **post)
        got = _sharded(c, normalized, (2, 4))
        np.testing.assert_array_equal(got, _one_shot(c, normalized))
        np.testing.assert_array_equal(got, _ref_sharded(c, normalized,
                                                        (2, 4)))


def test_sharded_merge_dense_stack_equals_reference():
    """Merge 0.8 on a dense stack (a (32, 128, 128) crop of 500 nuclei in
    48x128x256) over a (2, 4) mesh at shard halo 8, where a merge chain
    reaches a y-window's edge: the shards test their cores' faces on the
    reconciled basins, so the labels equal the one-shot labels, the port's
    and the JAX package's, elementwise. (The JAX package's sharded path
    merges each extended slab before the reconciliation and takes a basin
    the slab cuts off into the chain: it differs from one shot here, by
    1243 voxels.)"""
    from tpuseg_torch.data.normalize import histogram_percentile_normalize

    sv = synthesize_volume(shape=(48, 128, 256), num_instances=500, seed=2)
    v = histogram_percentile_normalize(torch.from_numpy(sv.image)[None])[0]
    v = np.ascontiguousarray(v.numpy()[:32, :, 128:])
    cfg = Config(infer=InferConfig(tile=(32, 128, 128), halo=0,
                                   compute_dtype="float32", shard_halo=8),
                 postproc=PostprocConfig(merge_saddle_ratio=0.8))
    got = _sharded(cfg, v, (2, 4))
    assert got.max() >= 150
    want = _one_shot(cfg, v)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, np.asarray(ref_make_infer_fn(
        RefAnalyticNet(), cfg, normalize=False)({"params": {}},
                                                jnp.asarray(v))))
    # the crop tells the two designs apart
    assert (got != _ref_sharded(cfg, v, (2, 4))).any()


@pytest.mark.parametrize("mesh", [make_z_mesh(devices=CPU8[:2]),
                                  make_zy_mesh((2, 2), devices=CPU8[:4])],
                         ids=["z2", "zy2x2"])
def test_sharded_merge_reads_far_roots(cfg, mesh):
    """``tall_pair`` turned to z: A's root lies 26 planes before the z
    seam, and the second z-shard roots A's part at its window's edge. A
    group's maximum is read at its root, so A and B stay apart at merge
    0.35 as in one shot. (Merging each extended slab first, as the JAX
    package does, joins them.)"""
    v = np.ascontiguousarray(tall_pair().transpose(1, 0, 2))
    c = _with(cfg, merge_saddle_ratio=0.35)
    want = _one_shot(c, v)
    assert want.max() == 2
    infer = make_sharded_infer_fn(AnalyticNet(), port_config(c), mesh,
                                  normalize=False)
    np.testing.assert_array_equal(unshard(infer(shard_volume(v, mesh)),
                                          mesh), want)


@pytest.fixture(scope="module")
def trained_unet():
    """The real 2-level U-Net (receptive field 11), trained 40 steps by the
    port's trainer on one synthetic volume, and the same weights in the JAX
    package's variables. (The JAX trainer takes about a minute on a CPU;
    the port's, under 10 s.)"""
    from tpuseg.ckpt.torch_import import flax_variables_from_torch
    from tpuseg.core import DataConfig, ModelConfig, TrainConfig
    from tpuseg.ops.calibrate import expected_fg_fraction
    from tpuseg_torch.data import synthesize_volume as port_synthesize
    from tpuseg_torch.train import train

    shape, n = (128, 32, 24), 14
    vol = synthesize_volume(shape=shape, num_instances=n,
                            radius_range=(3.5, 5.5), seed=7)
    frac = expected_fg_fraction(vol.half_sizes, vol.image.size)
    # x fits one tile and needs no tile halo; z and y take the mesh's cuts
    # and a halo of 12 >= the receptive field
    cfg = Config(
        model=ModelConfig(features=(8, 16), num_groups=4, head_features=8,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(24, 24, 24), batch_size=2,
                        max_instances=16, peak_sigma=2.5),
        train=TrainConfig(total_steps=40, warmup_steps=10, lr=3e-3,
                          log_every=40, ckpt_every=10_000),
        infer=InferConfig(tile=(64, 48, 24), halo=(12, 12, 0),
                          compute_dtype="float32", shard_halo=16,
                          shard_max_labels=256),
        postproc=PostprocConfig(peak_threshold=0.35, fg_threshold=0.5,
                                nms_radius=2, min_size=20, flood_iters=12,
                                fg_target_fraction=frac))
    state, _ = train(port_config(cfg), [port_synthesize(
        shape=shape, num_instances=n, radius_range=(3.5, 5.5), seed=7)],
        device="cpu")
    model = state.model.eval()
    variables = flax_variables_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return cfg, vol, model, variables


def test_sharded_equals_single_device_real_unet(trained_unet):
    """The real U-Net through the sharded path on z8 (slabs of 16 = the
    shard halo, >= its receptive field) and on (4, 2): the port's one-shot
    labels elementwise, and the JAX package's one-shot labels on the same
    weights (which its own test holds equal to its sharded labels)."""
    from tpuseg.models import build_model as ref_build_model

    cfg, vol, model, variables = trained_unet
    want = np.asarray(ref_make_infer_fn(ref_build_model(cfg.model), cfg)(
        variables, jnp.asarray(vol.image)))
    assert want.max() >= 12
    np.testing.assert_array_equal(_one_shot(cfg, vol.image, normalize=True,
                                            model=model), want)
    for mesh_shape in (None, (4, 2)):
        got = _sharded(cfg, vol.image, mesh_shape, normalize=True,
                       model=model)
        np.testing.assert_array_equal(got, want)


def test_sharded_counts_stay_on_the_function(cfg, normalized, capsys):
    """A call keeps its label-table overflow (0-d) and the merge's dropped
    pairs ((3,)) on ``infer`` as tensors; on the CPU the overflow prints at
    once in the reference's words, so ``report_sharded_counts`` has nothing
    left to print. The overflow drops instances but keeps the labels
    dense."""
    c = _with(cfg, merge_saddle_ratio=0.5)
    c = dataclasses.replace(c, infer=dataclasses.replace(
        c.infer, shard_max_labels=2))
    mesh = make_z_mesh(devices=CPU8[:2])
    infer = make_sharded_infer_fn(AnalyticNet(), port_config(c), mesh,
                                  normalize=False)
    assert infer.last_overflow is None
    labels = unshard(infer(shard_volume(normalized, mesh)), mesh)
    n = infer.last_overflow
    assert n.dim() == 0 and int(n) > 2
    assert SHARD_OVERFLOW.format(c=int(n), cap=2) in capsys.readouterr().out
    assert infer.last_merge_dropped.tolist() == [0, 0, 0]
    report_sharded_counts(infer)
    assert capsys.readouterr().out == ""
    ids = np.unique(labels)
    assert 1 <= ids.max() <= 4 and (ids == np.arange(ids.size)).all()
