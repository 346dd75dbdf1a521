"""The port's U-Net variants (``model.norm`` "group" / "none",
``model.activation`` "relu" / "silu" / "gelu"; ``tpuseg_torch/models``) ==
the JAX package's, with weights carried across by ``port_state_from_jax``
and gradients carried back by ``jax_variables_from_port``.

Small nets (features (4, 8), head 4, 2 groups), a (2, 8, 8, 12) batch.
Group norm and no norm have no running statistics, so the train-mode
forward is the eval forward; one run gives both the logits and the
gradients of the probe loss ``sum(out * r)``. Tolerances:

* float32 logits: 1e-4 absolute (logits of magnitude ~10; the group
  statistics are summed in another order, measured up to 1.7e-5);
* float32 parameter gradients: 1e-4 of each gradient's max magnitude
  (summation order only, measured up to 1.6e-5; no batch-norm backward
  amplifies it here);
* bfloat16 logits: held against the JAX package's float32 run, the port's
  error may be at most 1.25x the JAX package's own bf16 error (measured
  0.10-0.15 for both, from per-layer rounding of O(1) activations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import ModelConfig
from tpuseg.models import build_model as ref_build_model
from tpuseg_torch.ckpt import jax_variables_from_port
from tpuseg_torch.models import UNet3D
from tpuseg_torch.models.fused_eval import make_fused_apply
from tpuseg_torch.models.fused_train import make_fused_train_apply

from test_torch_model import (_port_model, _randomized_variables, port_config,
                              single_torch_thread)  # noqa: F401

SMALL = dict(features=(4, 8), head_features=4, num_groups=2)
VARIANTS = [(n, a) for n in ("group", "none") for a in ("relu", "silu", "gelu")]


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 8, 8, 12, 1), np.float32)
    r = {k: rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
         for k in ("fg_logits", "peak_logits")}
    return x, r


def _ref_run(cfg, variables, x, r):
    """JAX side: logits and parameter gradients of the probe loss (no
    batch statistics in these variants)."""
    model = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(x), train=True)
        return sum(jnp.sum(out[k] * r[k]) for k in r), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return out, grads


def _port_run(cfg, variables, x, r):
    model = _port_model(cfg, variables).train()
    out = model(torch.from_numpy(x[..., 0]))
    sum((out[k] * torch.from_numpy(r[k])).sum() for k in r).backward()
    grads = jax_variables_from_port(
        {k: p.grad for k, p in model.named_parameters()})["params"]
    return out, grads


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _logit_err(out, want):
    return max(float(np.abs(np.asarray(
        out[k].detach().numpy() if torch.is_tensor(out[k]) else out[k])
        - np.asarray(want[k])).max()) for k in ("fg_logits", "peak_logits"))


@pytest.mark.parametrize("norm,activation", VARIANTS)
def test_variant_logits_and_gradients_match_flax(norm, activation):
    cfg = ModelConfig(norm=norm, activation=activation,
                      compute_dtype="float32", **SMALL)
    variables = _randomized_variables(cfg, seed=7)
    if norm == "none":     # the conv biases the variant adds are carried
        assert "bias" in variables["params"]["enc0"]["conv0"]
    x, r = _inputs()
    (out, grads), (want, want_grads) = (_port_run(cfg, variables, x, r),
                                        _ref_run(cfg, variables, x, r))
    assert _logit_err(out, want) < 1e-4
    got_g, want_g = _leaves(grads), _leaves(want_grads)
    assert got_g.keys() == want_g.keys()
    for k in got_g:
        scale = max(float(np.abs(want_g[k]).max()), 1e-12)
        assert float(np.abs(got_g[k] - want_g[k]).max()) < 1e-4 * scale, k


@pytest.mark.parametrize("norm,activation", [("group", "gelu"),
                                             ("none", "silu")])
def test_variant_bf16_logits_match_flax(norm, activation):
    cfg = ModelConfig(norm=norm, activation=activation,
                      compute_dtype="bfloat16", **SMALL)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    variables = _randomized_variables(cfg, seed=8)
    x, r = _inputs(2)
    want32, _ = _ref_run(cfg32, variables, x, r)
    want, _ = _ref_run(cfg, variables, x, r)
    with torch.no_grad():
        got = _port_model(cfg, variables)(torch.from_numpy(x[..., 0]))
    assert got["fg_logits"].dtype == torch.float32
    assert _logit_err(got, want32) <= 1.25 * _logit_err(want, want32)


@pytest.mark.parametrize("norm,activation", [("group", "relu"),
                                             ("batch", "gelu")])
def test_fused_applies_refuse_variants(norm, activation):
    """The fused eval and train applies cover the batch-norm/ReLU family
    alone."""
    model = UNet3D(port_config(ModelConfig(
        features=(32, 64), head_features=32, norm=norm,
        activation=activation)))
    with pytest.raises(ValueError, match="fused eval apply requires"):
        make_fused_apply(model)
    with pytest.raises(ValueError, match="fused train apply requires"):
        make_fused_train_apply(model)


def test_variant_state_names_follow_the_mirror():
    """GroupNorm's affine is ``normN.weight`` / ``.bias`` (the mirror's
    ``nn.GroupNorm``), no norm leaves only the convs with their biases;
    ``Down`` and the up-convs keep their biases in every variant."""
    group = UNet3D(port_config(ModelConfig(norm="group", **SMALL)))
    none = UNet3D(port_config(ModelConfig(norm="none", **SMALL)))
    assert group.enc0.norm0.num_groups == 2 and group.enc0.norm0.eps == 1e-6
    assert "enc0.norm0.weight" in group.state_dict()
    assert not any(".norm" in k for k in none.state_dict())
    for m in (group, none):
        assert m.down0.down.bias is not None and m.up0.up_conv.bias is not None
    assert group.enc0.conv0.bias is None and none.enc0.conv0.bias is not None
