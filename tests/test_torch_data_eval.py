"""The port's touching-nuclei fixture, exact percentile normalization, HDF5
and TIFF volumes, visualization, ``cli.evaluate`` and ``cli.export`` == the
JAX package's on the same inputs.

Fixtures, files, images and JSON are compared byte for byte or
elementwise. The one float result, ``percentile_normalize``, agrees to
1e-6 (see its test for the one place the reference's own float32
rounding differs)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ckpt.torch_import import (load_pth_checkpoint,
                                      torch_state_dict_from_flax)
from tpuseg.cli import evaluate as ref_cli_evaluate
from tpuseg.cli import export as ref_cli_export
from tpuseg.core import ModelConfig
from tpuseg.data import synthesize_touching_volume as ref_touching
from tpuseg.data import volume_io as ref_io
from tpuseg.data.normalize import percentile_normalize as ref_pnorm
from tpuseg.eval import viz as ref_viz
from tpuseg.models import build_model as ref_build_model
from tpuseg_torch.ckpt import CheckpointManager, jax_variables_from_port
from tpuseg_torch.cli import evaluate as cli_evaluate
from tpuseg_torch.cli import export as cli_export
from tpuseg_torch.data import (load_volume, percentile_normalize, save_volume,
                               synthesize_touching_volume)
from tpuseg_torch.eval import viz

from test_torch_model import (_port_model, _randomized_variables,
                              single_torch_thread)  # noqa: F401

# bench.py's five c5 fixtures (bench.py:353-364), at a small shape
C5 = {
    "touch60_snr20": dict(touch_factor=0.6, noise=0.05),
    "touch60_snr8": dict(touch_factor=0.6, noise=0.12),
    "touch50_overlap": dict(touch_factor=0.5, noise=0.05),
    "touch70_gradient": dict(touch_factor=0.7, noise=0.05, gradient=0.3),
    "touch65_aniso035": dict(touch_factor=0.65, noise=0.05,
                             anisotropy=(0.35, 1.0, 1.0)),
}


@pytest.mark.parametrize("name", list(C5))
def test_touching_fixture_is_byte_equal(name):
    kw = dict(shape=(32, 64, 64), num_pairs=6, num_singles=4,
              radius_range=(5.0, 8.0), seed=17, **C5[name])
    a, b = synthesize_touching_volume(**kw), ref_touching(**kw)
    assert a.labels.max() >= 10
    for field in ("image", "labels", "centers", "half_sizes"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("shape,pcts", [((7, 13, 19), (1.0, 99.8)),
                                        ((16, 24, 40), (1.0, 99.8)),
                                        ((7, 13, 19), (25.0, 75.0)),
                                        ((5, 8, 9), (12.5, 87.5))])
def test_percentile_normalize_matches(shape, pcts):
    """Within 1e-6 of the JAX package's. The reference's XLA CPU program
    computes the order-statistic position ``p / 100 * (n - 1)`` one float32
    ulp off the correctly rounded value at some sizes (1724.5439 for
    1724.5441 at n = 1729), which moves the interpolated percentile by
    ~5e-5; the port rounds correctly, as ``jnp.quantile(vol, p / 100)``
    does, so the default percentiles are held to that form of the
    reference. Percentiles with an exact position need no such care."""
    vol = (np.random.default_rng(sum(shape)).normal(size=shape) * 3 + 1
           ).astype(np.float32)
    got = percentile_normalize(torch.from_numpy(vol), pcts)
    assert got.dtype == torch.float32
    if pcts == (1.0, 99.8):
        q = jnp.quantile(jnp.asarray(vol),
                         jnp.asarray(pcts, jnp.float32) / 100.0)
        want = np.clip((vol - np.float32(q[0]))
                       / max(np.float32(q[1] - q[0]), np.float32(1e-6)), 0, 1)
    else:
        want = np.asarray(ref_pnorm(vol, pcts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ext", [".h5", ".tif"])
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint16])
def test_h5_and_tiff_cross_read(tmp_path, ext, writer, reader, dtype):
    vol = (np.random.default_rng(0).random((4, 9, 11)) * 1000).astype(dtype)
    path = str(tmp_path / f"v{ext}")
    (save_volume if writer == "port" else ref_io.save_volume)(path, vol)
    got = (load_volume if reader == "port" else ref_io.load_volume)(path)
    assert got.dtype == vol.dtype
    np.testing.assert_array_equal(got, vol)


def test_missing_io_package_is_named(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="need the h5py package"):
        save_volume(str(tmp_path / "v.h5"), np.zeros((2, 2, 2)))


def _viz_fixture():
    img = np.random.default_rng(0).random((8, 16, 16)).astype(np.float32)
    lab = np.zeros((8, 16, 16), np.int32)
    lab[2:5, 2:6, 2:6] = 1
    lab[5:7, 10:14, 10:14] = 2
    lab[0, 0:3, 8:12] = 7
    return img, lab


def test_viz_arrays_and_files_match(tmp_path):
    img, lab = _viz_fixture()
    np.testing.assert_array_equal(viz.label_colors(50, seed=3),
                                  ref_viz.label_colors(50, seed=3))
    np.testing.assert_array_equal(viz.colorize_labels(lab),
                                  ref_viz.colorize_labels(lab))
    ov = viz.overlay(img, lab, alpha=0.3)
    np.testing.assert_array_equal(ov, ref_viz.overlay(img, lab, alpha=0.3))
    np.testing.assert_array_equal(viz.max_projection(ov, axis=1),
                                  ref_viz.max_projection(ov, axis=1))
    for projection, name in ((0, "p.png"), (None, "s.tif")):
        viz.export_overlay(str(tmp_path / f"port_{name}"), img, lab,
                           projection=projection)
        ref_viz.export_overlay(str(tmp_path / f"ref_{name}"), img, lab,
                               projection=projection)
        assert ((tmp_path / f"port_{name}").read_bytes()
                == (tmp_path / f"ref_{name}").read_bytes())


@pytest.mark.parametrize("argv", [[], ["--criterion", "center"],
                                  ["--iou-threshold", "0.7"]])
def test_cli_evaluate_json_matches(tmp_path, capsys, argv):
    tv = synthesize_touching_volume(shape=(16, 32, 32), num_pairs=3,
                                    num_singles=2, seed=4)
    pred = tv.labels.copy()
    pred[tv.labels == 1] = 0                      # a missed instance
    pred[:, :, :3] = 99                           # a false positive slab
    paths = []
    for name, v in (("pred.npy", pred), ("gt.h5", tv.labels)):
        paths.append(str(tmp_path / name))
        save_volume(paths[-1], v)
    args = ["--pred", paths[0], "--gt", paths[1], *argv]
    cli_evaluate.main(args)
    got = capsys.readouterr().out
    ref_cli_evaluate.main(args)
    want = capsys.readouterr().out
    assert got == want and 0 < json.loads(got)["f1"] < 1


@pytest.mark.parametrize("source", ["pth", "trainer_dir"])
def test_cli_export_loads_in_the_reference(tmp_path, capsys, source):
    """A port checkpoint through ``cli.export`` -> the JAX package's
    ``load_pth_checkpoint`` -> flax apply == the port's apply (float32
    logits to 1e-4, as tests/test_torch_model.py), the variables exactly;
    the summary line and the written tensors equal the reference export's
    of the same ``.pth``."""
    cfg = ModelConfig(features=(4, 8), head_features=4, num_groups=2,
                      norm="group", compute_dtype="float32")
    variables = _randomized_variables(cfg, seed=9)
    model = _port_model(cfg, variables)
    ckpt = str(tmp_path / "in.pth")
    torch.save(model.state_dict(), ckpt)
    if source == "trainer_dir":
        ckpt = str(tmp_path / "trainer")
        params = {k: v for k, v in model.state_dict().items()}
        CheckpointManager(ckpt).save(3, params, {}, {"step": 3})
    sets = ["--set", "model.features=[4,8]", "--set", "model.head_features=4",
            "--set", "model.num_groups=2", "--set", 'model.norm="group"']
    out = str(tmp_path / "out.pth")
    cli_export.main(["--checkpoint", ckpt, "--output", out, *sets])
    line = capsys.readouterr().out.strip()
    loaded = load_pth_checkpoint(out)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(
                        jax_variables_from_port(model.state_dict()))):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).random((1, 8, 8, 16, 1), np.float32)
    want = ref_build_model(cfg).apply(jax.tree.map(jnp.asarray, loaded),
                                      jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x[..., 0]))
    for k in ("fg_logits", "peak_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4)
    ref_out = str(tmp_path / "ref.pth")
    ref_cli_export.main(["--checkpoint", str(tmp_path / "in.pth"),
                         "--output", ref_out, *sets])
    ref_line = capsys.readouterr().out.strip()
    assert line.split(": ", 1)[1] == ref_line.split(": ", 1)[1]
    a, b = torch.load(out), torch.load(ref_out)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a) == set(torch_state_dict_from_flax(loaded))
