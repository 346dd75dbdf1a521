"""The port's end-to-end inference (``tpuseg_torch/infer/pipeline.py``) ==
``tpuseg.infer.make_infer_fn`` on the same volume.

With the pointwise AnalyticNet stand-in the two pipelines see identical
float32 logits, so their labels must agree elementwise. With a small U-Net
the logits agree only to float32 summation order (test_torch_model.py), and
untrained logits sit near the sigmoid-0.5 threshold, so a few voxels may
flip: there the bound is on instance count and voxel agreement."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpuseg.core import Config, InferConfig, ModelConfig, PostprocConfig
from tpuseg.data import synthesize_volume
from tpuseg.infer import make_infer_fn as ref_make_infer_fn
from tpuseg.models import build_model as ref_build_model
from tpuseg_torch.infer import make_infer_fn, make_infer_stages
from tpuseg_torch.models import UNet3D

from chip_smoke import AnalyticNet      # the same stand-in as a torch module
from test_torch_model import (_port_model, _randomized_variables,
                              single_torch_thread)  # noqa: F401


class RefAnalyticNet(fnn.Module):
    """tests/unit/test_streaming.py's AnalyticNet (receptive field 0)."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        v = x[..., 0].astype(jnp.float32)
        return {"fg_logits": (v - 0.35) * 25.0, "peak_logits": (v - 0.75) * 25.0}


def _cfg(**infer):
    return Config(
        infer=InferConfig(**{"tile": (8, 32, 64), "halo": 4,
                             "compute_dtype": "float32", **infer}),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16),
    )


@pytest.fixture(scope="module")
def volume():
    return synthesize_volume(shape=(16, 32, 128), num_instances=10,
                             radius_range=(3.0, 5.0), noise=0.03, seed=2)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("infer", [{}, {"tile_batch": 3, "program": "staged"}])
def test_analytic_pipeline_labels_equal(volume, normalize, infer):
    cfg = _cfg(**infer)
    image = volume.image * (517.0 if normalize else 1.0)
    want = np.asarray(ref_make_infer_fn(RefAnalyticNet(), cfg, normalize)(
        {"params": {}}, jnp.asarray(image)))
    got = make_infer_fn(AnalyticNet(), cfg, normalize)(torch.from_numpy(image))
    assert got.dtype == torch.int32
    assert want.max() >= 5
    np.testing.assert_array_equal(got.numpy(), want)


def test_analytic_pipeline_diagnostics(volume):
    cfg = dataclasses.replace(_cfg(), postproc=dataclasses.replace(
        _cfg().postproc, flood_iters=2, fg_threshold=0.2))
    want, wdiag = ref_make_infer_fn(RefAnalyticNet(), cfg,
                                    with_diagnostics=True)(
        {"params": {}}, jnp.asarray(volume.image))
    got, diag = make_infer_fn(AnalyticNet(), cfg, with_diagnostics=True)(
        torch.from_numpy(volume.image))
    assert diag["flood_truncated"] == int(wdiag["flood_truncated"]) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stages_compose_and_plain_twins_agree(volume):
    infer, stage_net, stage_post = make_infer_stages(AnalyticNet(), _cfg())
    _, _, plain_post = make_infer_stages(AnalyticNet(), _cfg(), plain=True)
    vol = torch.from_numpy(volume.image)
    logits = stage_net(vol)
    assert logits["fg_logits"].shape == vol.shape
    a = stage_post(logits)
    assert torch.equal(a, infer(vol))
    assert torch.equal(a, plain_post(logits))


def test_unet_pipeline_instance_agreement(volume):
    """Small random U-Net, float32, halo >= its receptive field, thresholds
    at quantiles of its own probability maps: instance count within 2 and
    >= 99% voxel agreement of the label volumes (allowing the few threshold
    flips noted in the module docstring)."""
    mcfg = ModelConfig(features=(8, 16), head_features=8,
                       compute_dtype="float32")
    variables = _randomized_variables(mcfg, seed=7)
    model = _port_model(mcfg, variables)
    cfg = dataclasses.replace(_cfg(halo=12, tile=(16, 32, 64)), model=mcfg)
    logits = make_infer_stages(model, cfg)[1](torch.from_numpy(volume.image))
    fg_thr, peak_thr = (
        float(np.quantile(torch.sigmoid(logits[k]).numpy(), q))
        for k, q in (("fg_logits", 0.5), ("peak_logits", 0.9)))
    cfg = dataclasses.replace(cfg, postproc=dataclasses.replace(
        cfg.postproc, fg_threshold=fg_thr, peak_threshold=peak_thr,
        flood_iters=64))
    want = np.asarray(ref_make_infer_fn(ref_build_model(mcfg), cfg)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(volume.image)))
    got = make_infer_fn(model, cfg)(torch.from_numpy(volume.image)).numpy()
    assert want.max() >= 5
    assert abs(int(got.max()) - int(want.max())) <= 2
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("key,value", [("infer.apply_impl", "fused"),
                                       ("postproc.fg_target_fraction", 0.1),
                                       ("postproc.merge_saddle_ratio", 0.8)])
def test_unported_config_raises(key, value):
    cfg = Config().override(**{key: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_infer_fn(UNet3D(ModelConfig(features=(4, 8), head_features=4)), cfg)
