"""The port's batched inference, one-shot convenience call and measured
receptive field (``tpuseg_torch/infer/pipeline.make_batched_infer_fn``,
``infer_volume``, ``infer/tiles.measure_rf_radius``) == the JAX package's.

With the pointwise AnalyticNet both packages see identical float32 logits,
so labels are compared elementwise; the receptive-field radius is an
integer and compared exactly (float32 nets, the reference's tolerance:
only voxels outside the impulse's cone see bitwise equal logits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import Config, InferConfig, ModelConfig, PostprocConfig
from tpuseg.data import synthesize_volume
from tpuseg.infer import make_batched_infer_fn as ref_make_batched_infer_fn
from tpuseg.infer.tiles import measure_rf_radius as ref_measure_rf_radius
from tpuseg.models import build_model as ref_build_model
from tpuseg_torch.infer import (infer_volume, make_batched_infer_fn,
                                make_infer_fn, measure_rf_radius,
                                rf_radius_bound)

from chip_smoke import AnalyticNet
from test_torch_model import (_port_model, _randomized_variables, port_config,
                              single_torch_thread)  # noqa: F401
from test_torch_pipeline import RefAnalyticNet


def _cfg(program="fused", fraction=0.0):
    return Config(
        infer=InferConfig(tile=(8, 16, 32), halo=2, compute_dtype="float32",
                          program=program),
        postproc=PostprocConfig(min_size=5, flood_iters=12,
                                fg_target_fraction=fraction))


@pytest.fixture(scope="module")
def volumes():
    """Three volumes at distinct intensity scales: each must be normalized
    with its own percentiles."""
    return np.stack([
        synthesize_volume(shape=(12, 24, 40), num_instances=5,
                          radius_range=(3.0, 4.5), seed=s).image * (1.0 + s)
        for s in range(3)])


@pytest.mark.parametrize("program,fraction", [("fused", 0.0),
                                              ("staged", 0.0),
                                              ("fused", 0.08)])
def test_batched_labels_match_reference(volumes, program, fraction):
    cfg = _cfg(program, fraction)
    want = np.asarray(ref_make_batched_infer_fn(RefAnalyticNet(), cfg)(
        {"params": {}}, jnp.asarray(volumes)))
    batched = make_batched_infer_fn(AnalyticNet(), port_config(cfg))
    got = batched(torch.from_numpy(volumes))
    assert got.dtype == torch.int32 and got.shape == volumes.shape
    assert all(want[i].max() >= 3 for i in range(len(volumes)))
    np.testing.assert_array_equal(got.numpy(), want)
    single = make_infer_fn(AnalyticNet(), port_config(cfg))
    for i, v in enumerate(volumes):
        assert torch.equal(got[i], single(torch.from_numpy(v)))


def test_batched_refuses_unknown_program():
    with pytest.raises(ValueError, match="unknown InferConfig.program"):
        make_batched_infer_fn(AnalyticNet(), port_config(_cfg("bogus")))


def test_infer_volume_takes_arrays(volumes):
    cfg = port_config(_cfg())
    got = infer_volume(AnalyticNet(), volumes[1], cfg, device="cpu")
    want = make_infer_fn(AnalyticNet(), cfg)(torch.from_numpy(volumes[1]))
    assert got.device.type == "cpu" and torch.equal(got, want)


@pytest.mark.parametrize("features,probe", [((4,), 16), ((4, 8), 32)])
def test_measure_rf_radius_matches(features, probe):
    cfg = ModelConfig(features=features, head_features=4, num_groups=2,
                      compute_dtype="float32")
    variables = _randomized_variables(cfg, seed=11)
    want = ref_measure_rf_radius(ref_build_model(cfg),
                                 jax.tree.map(jnp.asarray, variables),
                                 probe_size=probe)
    model = _port_model(cfg, variables).train()
    got = measure_rf_radius(model, probe_size=probe)
    assert got == want == rf_radius_bound(len(features))
    assert model.training                  # the mode it was given back in
