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
from tpuseg_torch.core import Config as PortConfig
from tpuseg_torch.core import ModelConfig as PortModelConfig
from tpuseg_torch.infer import make_infer_fn, make_infer_stages
from tpuseg_torch.models import UNet3D

from chip_smoke import AnalyticNet      # the same stand-in as a torch module
from test_torch_model import (_port_model, _randomized_variables,
                              single_torch_thread)  # noqa: F401
from test_torch_model import port_config as _port_cfg


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
    got = make_infer_fn(AnalyticNet(), _port_cfg(cfg), normalize)(
        torch.from_numpy(image))
    assert got.dtype == torch.int32
    assert want.max() >= 5
    np.testing.assert_array_equal(got.numpy(), want)


def test_analytic_pipeline_diagnostics(volume):
    cfg = dataclasses.replace(_cfg(), postproc=dataclasses.replace(
        _cfg().postproc, flood_iters=2, fg_threshold=0.2))
    want, wdiag = ref_make_infer_fn(RefAnalyticNet(), cfg,
                                    with_diagnostics=True)(
        {"params": {}}, jnp.asarray(volume.image))
    got, diag = make_infer_fn(AnalyticNet(), _port_cfg(cfg),
                              with_diagnostics=True)(
        torch.from_numpy(volume.image))
    assert diag["flood_truncated"] == int(wdiag["flood_truncated"]) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stages_compose_and_plain_twins_agree(volume):
    cfg = _port_cfg(_cfg())
    infer, stage_net, stage_post = make_infer_stages(AnalyticNet(), cfg)
    _, _, plain_post = make_infer_stages(AnalyticNet(), cfg, plain=True)
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
    logits = make_infer_stages(model, _port_cfg(cfg))[1](
        torch.from_numpy(volume.image))
    fg_thr, peak_thr = (
        float(np.quantile(torch.sigmoid(logits[k]).numpy(), q))
        for k, q in (("fg_logits", 0.5), ("peak_logits", 0.9)))
    cfg = dataclasses.replace(cfg, postproc=dataclasses.replace(
        cfg.postproc, fg_threshold=fg_thr, peak_threshold=peak_thr,
        flood_iters=64))
    want = np.asarray(ref_make_infer_fn(ref_build_model(mcfg), cfg)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(volume.image)))
    got = make_infer_fn(model, _port_cfg(cfg))(
        torch.from_numpy(volume.image)).numpy()
    assert want.max() >= 5
    assert abs(int(got.max()) - int(want.max())) <= 2
    assert (got == want).mean() >= 0.99


def test_fused_pipeline_instance_agreement(volume):
    """``infer.apply_impl="fused"`` (K4's path; its plain twin on the CPU)
    against the JAX pipeline under the same setting (Pallas in interpret
    mode): small random U-Net of the fused family, float32, thresholds at
    quantiles of its own probability maps; instance count within 2 and
    >= 99% voxel agreement, as ``test_unet_pipeline_instance_agreement``.
    The fused logits equal the module path's to summation order."""
    from jax.experimental.pallas import tpu as pltpu

    mcfg = ModelConfig(features=(32, 64), head_features=32,
                       compute_dtype="float32")
    variables = _randomized_variables(mcfg, seed=11)
    model = _port_model(mcfg, variables)
    cfg = dataclasses.replace(_cfg(apply_impl="fused"), model=mcfg)
    vol = torch.from_numpy(volume.image)
    logits = make_infer_stages(model, _port_cfg(cfg))[1](vol)
    plain = make_infer_stages(model, _port_cfg(dataclasses.replace(
        cfg, infer=dataclasses.replace(cfg.infer, apply_impl="flax"))))[1](vol)
    for k in logits:
        np.testing.assert_allclose(logits[k].numpy(), plain[k].numpy(),
                                   rtol=2e-3, atol=2e-3)
    fg_thr, peak_thr = (
        float(np.quantile(torch.sigmoid(logits[k]).numpy(), q))
        for k, q in (("fg_logits", 0.5), ("peak_logits", 0.9)))
    cfg = dataclasses.replace(cfg, postproc=dataclasses.replace(
        cfg.postproc, fg_threshold=fg_thr, peak_threshold=peak_thr,
        flood_iters=64))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_make_infer_fn(ref_build_model(mcfg), cfg)(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(volume.image)))
    got = make_infer_fn(model, _port_cfg(cfg))(vol).numpy()
    assert want.max() >= 5
    assert abs(int(got.max()) - int(want.max())) <= 2
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("postproc", [{"nms_impl": "pallas"},
                                      {"method": "flood"},
                                      {"method": "flood", "nms_impl": "pallas"}],
                         ids=["nms_pallas", "flood", "flood_nms_pallas"])
def test_analytic_pipeline_postproc_settings_equal(volume, postproc):
    """The peak-NMS kernel's composition and ``method="flood"`` through the
    whole pipeline: labels elementwise equal to the JAX pipeline's, and
    ``nms_impl="pallas"`` equal to the default path's."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = dataclasses.replace(_cfg(), postproc=dataclasses.replace(
        _cfg().postproc, **postproc))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_make_infer_fn(RefAnalyticNet(), cfg)(
            {"params": {}}, jnp.asarray(volume.image)))
    vol = torch.from_numpy(volume.image)
    got = make_infer_fn(AnalyticNet(), _port_cfg(cfg))(vol)
    assert want.max() >= 5
    np.testing.assert_array_equal(got.numpy(), want)
    if postproc == {"nms_impl": "pallas"}:
        assert torch.equal(got, make_infer_fn(AnalyticNet(),
                                              _port_cfg(_cfg()))(vol))


@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_analytic_pipeline_saddle_merge_equal(ratio):
    """``postproc.merge_saddle_ratio`` (the saddle merge after the
    diagnostics, before the size filter): labels elementwise equal to the
    JAX pipeline's. Noisy blobs under NMS radius 1 seed some nuclei twice;
    the merge joins those."""
    image = synthesize_volume(shape=(16, 32, 128), num_instances=10,
                              radius_range=(3.0, 5.0), noise=0.08,
                              seed=2).image
    postproc = dict(nms_radius=1, min_size=1, merge_max_pairs=1024)
    cfgs = [dataclasses.replace(_cfg(), postproc=dataclasses.replace(
        _cfg().postproc, merge_saddle_ratio=r, **postproc)) for r in (0, ratio)]
    want = np.asarray(ref_make_infer_fn(RefAnalyticNet(), cfgs[1])(
        {"params": {}}, jnp.asarray(image)))
    unmerged, got = (make_infer_fn(AnalyticNet(), _port_cfg(c))(
        torch.from_numpy(image)) for c in cfgs)
    assert 5 <= want.max() < unmerged.max()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("key,value", [("infer.apply_impl", "fused"),
                                       ("infer.apply_impl", "bogus")])
def test_unported_config_raises(key, value):
    """What ``make_infer_fn`` refuses: the fused apply for a model outside
    its family and an unknown ``apply_impl`` (ValueError, as the JAX
    pipeline)."""
    exc, match = {
        "fused": (ValueError, "fused eval apply requires"),
        "bogus": (ValueError, "unknown apply_impl")}[value]
    cfg = PortConfig().override(**{key: value})
    with pytest.raises(exc, match=match):
        make_infer_fn(UNet3D(PortModelConfig(features=(4, 8), head_features=4)),
                      cfg)


def test_unknown_program_raises_as_in_reference(volume):
    """``infer.program`` outside {"fused", "staged"}: ValueError with the
    reference's wording, in both packages."""
    cfg = _cfg(program="bogus")
    with pytest.raises(ValueError, match="unknown InferConfig.program 'bogus'"):
        ref_make_infer_fn(RefAnalyticNet(), cfg)
    with pytest.raises(ValueError, match="unknown InferConfig.program 'bogus'"):
        make_infer_fn(AnalyticNet(), _port_cfg(cfg))
    with pytest.raises(ValueError, match="unknown InferConfig.program"):
        make_infer_stages(AnalyticNet(), PortConfig().override(
            **{"infer.program": "Fused"}))


@pytest.mark.parametrize("with_diagnostics", [False, True])
def test_fused_and_staged_programs_give_identical_labels(volume,
                                                         with_diagnostics):
    """Both accepted values name one computation in the port."""
    vol = torch.from_numpy(volume.image)
    out = [make_infer_fn(AnalyticNet(), _port_cfg(_cfg(program=program)),
                         with_diagnostics=with_diagnostics)(vol)
           for program in ("fused", "staged")]
    if with_diagnostics:
        assert out[0][1] == out[1][1]
        out = [o[0] for o in out]
    assert int(out[0].max()) >= 5
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("max_pairs", [1024, 1])
def test_merge_and_diagnostics_counts_stay_tensors(max_pairs):
    """Merge and diagnostics together: labels and the truncation count
    equal the JAX pipeline's; the truncation count is a 0-d int32 tensor
    on the volume's device, as the reference returns it, and the merge's
    (3,) dropped counts stay on ``saddle_merge.last_dropped`` (a cap of 1
    pair drops some, and the CPU warns at once)."""
    import warnings

    from tpuseg_torch.ops.merge import saddle_merge

    image = synthesize_volume(shape=(16, 32, 128), num_instances=10,
                              radius_range=(3.0, 5.0), noise=0.08,
                              seed=2).image
    cfg = dataclasses.replace(_cfg(), postproc=dataclasses.replace(
        _cfg().postproc, merge_saddle_ratio=0.5, nms_radius=1, min_size=1,
        merge_max_pairs=max_pairs))
    want, wdiag = ref_make_infer_fn(RefAnalyticNet(), cfg,
                                    with_diagnostics=True)(
        {"params": {}}, jnp.asarray(image))
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        got, diag = make_infer_fn(AnalyticNet(), _port_cfg(cfg),
                                  with_diagnostics=True)(
            torch.from_numpy(image))
    n = diag["flood_truncated"]
    assert isinstance(n, torch.Tensor) and n.dim() == 0
    assert n.dtype == torch.int32 and int(n) == int(wdiag["flood_truncated"])
    dropped = saddle_merge.last_dropped
    assert dropped.shape == (3,) and dropped.dtype == torch.int32
    assert (dropped.sum() > 0) == (max_pairs == 1)
    assert sum("saddle merge" in str(w.message) for w in log) == int(
        (dropped > 0).sum())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
