"""The port's fused eval apply (``tpuseg_torch/models/fused_eval.py``) ==
``tpuseg/models/fused_eval.make_fused_apply`` (Pallas in interpret mode) and
== flax ``model.apply``, on the same weights and the same numpy blocks.

On the CPU the three full-resolution blocks take K4's plain twin
(``ops/convblock.py``); the CUDA kernel is held against the same apply
through that twin on the card (``chip_smoke.py`` phase 12).

Tolerances are those of ``tests/unit/test_fused_eval.py``: float32 rtol/atol
2e-3 (the fused block applies a float32 affine to the float32 accumulator,
the module path rounds nothing either, so only summation order differs);
bfloat16 at least 99.5% of the voxels within 0.08*|w| + 0.08 (the module path
rounds the conv to bf16 before a bf16 affine, the fused block does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import ModelConfig as RefModelConfig
from tpuseg.models import build_model as ref_build_model
from tpuseg.models.fused_eval import make_fused_apply as ref_make_fused_apply
from tpuseg_torch.core import ModelConfig
from tpuseg_torch.models import UNet3D, build_model
from tpuseg_torch.models.fused_eval import (fused_apply_supported,
                                            make_fused_apply)

from test_torch_model import (_port_model, _randomized_variables,
                              single_torch_thread)  # noqa: F401

SHAPE = (8, 16, 24)


@pytest.fixture(scope="module", params=[
    ("float32", (32, 64), 1), ("float32", (32, 64, 128), 1),
    ("float32", (32, 64), 2), ("bfloat16", (32, 64), 1),
    ("bfloat16", (32, 64, 128), 2)],
    ids=lambda p: f"{p[0]}-{len(p[1])}levels-batch{p[2]}")
def case(request):
    """One set of weights and one batch of blocks through the three
    applies: the port's fused apply, the JAX package's (interpret mode) and
    flax ``model.apply``."""
    dtype, features, batch = request.param
    kw = dict(features=features, head_features=32, compute_dtype=dtype)
    variables = _randomized_variables(ModelConfig(**kw), seed=len(features))
    x = np.random.default_rng(2).standard_normal(
        (batch, *SHAPE, 1)).astype(np.float32)
    model = _port_model(ModelConfig(**kw), variables)
    got = make_fused_apply(model)(torch.from_numpy(x[..., 0]))
    ref_model = ref_build_model(RefModelConfig(**kw))
    jvars = jax.tree.map(jnp.asarray, variables)
    return {
        "dtype": dtype, "batch": batch,
        "got": {k: v.numpy() for k, v in got.items()},
        "fused": ref_make_fused_apply(ref_model, interpret=True)(
            jvars, jnp.asarray(x)),
        "flax": jax.jit(ref_model.apply)(jvars, jnp.asarray(x)),
    }


@pytest.mark.parametrize("ref", ["fused", "flax"])
def test_fused_apply_matches_jax(case, ref):
    for k in ("fg_logits", "peak_logits"):
        g, w = case["got"][k], np.asarray(case[ref][k])
        assert g.shape == w.shape == (case["batch"], *SHAPE)
        assert g.dtype == np.float32
        if case["dtype"] == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)
        else:
            close = np.abs(g - w) <= 0.08 * np.abs(w) + 0.08
            assert close.mean() > 0.995, (k, close.mean())


def test_fused_apply_takes_4d_blocks_and_plain_twin():
    model = build_model(ModelConfig(features=(32, 64)), seed=1)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 4, 8, 8), dtype=np.float32))
    a = make_fused_apply(model)(x)
    b = make_fused_apply(model)(x[:, None])
    c = make_fused_apply(model, plain=True)(x)
    for k in a:
        assert a[k].shape == (1, 4, 8, 8)
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
        assert not a[k].requires_grad


def test_fused_apply_supported_gating():
    assert fused_apply_supported(ModelConfig())
    assert fused_apply_supported(ModelConfig(features=(32, 64)))
    assert not fused_apply_supported(ModelConfig(norm="group"))
    assert not fused_apply_supported(ModelConfig(activation="gelu"))
    assert not fused_apply_supported(ModelConfig(features=(16, 32)))
    assert not fused_apply_supported(ModelConfig(features=(32,)))
    assert not fused_apply_supported(ModelConfig(head_features=16))
    with pytest.raises(ValueError, match="fused eval apply requires"):
        make_fused_apply(UNet3D(ModelConfig(features=(16, 32))))


def test_fused_apply_needs_eval_mode():
    model = build_model(ModelConfig(features=(32, 64)), seed=1)
    apply_fn = make_fused_apply(model)
    model.train()
    with pytest.raises(RuntimeError, match="eval"):
        apply_fn(torch.zeros(1, 4, 8, 8))
