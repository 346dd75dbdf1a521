"""The port's train-mode U-Net, K6 conv wrapper and fused train apply ==
the JAX package's, with weights carried across by ``port_state_from_jax``
and results carried back by ``jax_variables_from_port``.

Flagship family at test size: features (32, 64), head 32, patches
(8, 16, 64), batch 2 (``tests/unit/test_fused_train.py``'s setup). The
JAX fused apply runs its Pallas conv in interpret mode, as its own tests
do; the port's conv wrapper takes its plain version on CPU tensors.

Tolerances (float32 unless stated; the two sides differ in summation
order only):

* convolutions: 1e-4 relative to the output's (gradient's) max magnitude;
* train-mode U-Net and fused apply: logits 2e-4 absolute (O(1) logits
  after two BatchNorm'd levels), running statistics 1e-5 relative,
  parameter gradients 5e-2 of each gradient's max magnitude, the bound
  JAX's own fused-vs-flax test uses. BatchNorm's backward at batch 2
  amplifies rounding: against a float64 run of the port, the JAX package's
  float32 gradients are off by up to 1.9% (head_trunk.conv0) and the
  port's by up to 0.5%;
* bfloat16 U-Net: both sides' bf16 results are held against the JAX
  package's float32 run, and the port's error may be at most 1.25x the JAX
  package's own bf16 error (measured: gradients 21% vs 21% relative L2,
  logits 0.084 vs 0.078 max abs); the running statistics agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import ModelConfig
from tpuseg.models import build_model as ref_build_model
from tpuseg.models.fused_train import \
    make_fused_train_apply as ref_make_fused_train_apply
from tpuseg.ops.pallas_convtrain import conv3x3_p2
from tpuseg.ops.pallas_convtrain import flip_w as ref_flip_w
from tpuseg.ops.pallas_convtrain import pack2_w, unpack2_w, xla_conv3x3
from tpuseg_torch.ckpt import jax_variables_from_port
from tpuseg_torch.models.fused_train import make_fused_train_apply
from tpuseg_torch.ops import convtrain
from tpuseg_torch.ops.convtrain import conv3x3, conv3x3_plain, flip_w

from test_torch_model import (_port_model, _randomized_variables, port_config,
                              single_torch_thread)  # noqa: F401

PATCH = (8, 16, 64)


def _flagship(dtype="float32"):
    return ModelConfig(features=(32, 64), head_features=32,
                       compute_dtype=dtype)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    x = rng.random((2, *PATCH, 1), np.float32)
    r = {k: rng.normal(size=(2, *PATCH)).astype(np.float32)
         for k in ("fg_logits", "peak_logits")}
    return x, r


def _ref_run(cfg, variables, x, r, apply_fn=None):
    """JAX side: (logits, new batch_stats, param grads) of the train-mode
    forward and the probe loss sum(out * r)."""
    model = ref_build_model(cfg)
    vs = jax.tree.map(jnp.asarray, variables)

    def loss(params):
        v = {"params": params, "batch_stats": vs["batch_stats"]}
        if apply_fn is None:
            out, mut = model.apply(v, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            stats = mut["batch_stats"]
        else:
            out, stats = apply_fn(v, jnp.asarray(x))
        val = sum(jnp.sum(out[k] * r[k]) for k in r)
        return val, (out, stats)

    (_, (out, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        vs["params"])
    return out, stats, grads


def _port_run(cfg, variables, x, r, fused):
    model = _port_model(cfg, variables).train()
    fn = make_fused_train_apply(model) if fused else model
    out = fn(torch.from_numpy(x[..., 0]))
    sum((out[k] * torch.from_numpy(r[k])).sum() for k in r).backward()
    grads = jax_variables_from_port(
        {k: p.grad for k, p in model.named_parameters()})["params"]
    stats = jax_variables_from_port(model.state_dict())["batch_stats"]
    return out, stats, grads


def _compare(port, ref, out_atol=2e-4, grad_tol=5e-2):
    (out, stats, grads), (want_out, want_stats, want_grads) = port, ref
    for k in ("fg_logits", "peak_logits"):
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(want_out[k]), rtol=0,
                                   atol=out_atol)
    got_s, want_s = _leaves(stats), _leaves(want_stats)
    assert got_s.keys() == want_s.keys()
    for k in got_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    got_g, want_g = _leaves(grads), _leaves(want_grads)
    assert got_g.keys() == want_g.keys()
    for k in got_g:
        assert _rel_err(got_g[k], want_g[k]) < grad_tol, (
            k, _rel_err(got_g[k], want_g[k]))


def _whole_rel(got, want):
    g, w = _leaves(got), _leaves(want)
    return float(np.sqrt(sum(np.sum((g[k] - w[k]) ** 2) for k in g)
                         / sum(np.sum(w[k] ** 2) for k in g)))


def _logit_err(out, want):
    return max(float(np.abs(np.asarray(out[k].detach().numpy()
                                       if torch.is_tensor(out[k]) else out[k])
                            - np.asarray(want[k])).max())
               for k in ("fg_logits", "peak_logits"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_unet_matches_flax(inputs, dtype):
    cfg = _flagship(dtype)
    variables = _randomized_variables(cfg, seed=3)
    x, r = inputs
    port, ref = _port_run(cfg, variables, x, r, fused=False), \
        _ref_run(cfg, variables, x, r)
    if dtype == "float32":
        _compare(port, ref)
        return
    ref32 = _ref_run(_flagship("float32"), variables, x, r)
    assert _logit_err(port[0], ref32[0]) <= 1.25 * _logit_err(ref[0], ref32[0])
    assert _whole_rel(port[2], ref32[2]) <= 1.25 * _whole_rel(ref[2], ref32[2])
    got_s, want_s = _leaves(port[1]), _leaves(ref[1])
    for k in got_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_fused_train_apply_matches_jax(inputs):
    cfg = _flagship()
    variables = _randomized_variables(cfg, seed=4)
    x, r = inputs
    ref_apply = ref_make_fused_train_apply(ref_build_model(cfg),
                                           interpret=True)
    _compare(_port_run(cfg, variables, x, r, fused=True),
             _ref_run(cfg, variables, x, r, ref_apply))


def test_eval_mode_keeps_running_stats(inputs):
    cfg = _flagship()
    model = _port_model(cfg, _randomized_variables(cfg, seed=5))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.eval()(torch.from_numpy(inputs[0][..., 0]))
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
        model.train()(torch.from_numpy(inputs[0][..., 0]))
    assert not torch.equal(model.enc0.norm0.running_mean,
                           before["enc0.norm0.running_mean"])


def test_fused_apply_rejects_other_families():
    from tpuseg_torch.models import UNet3D

    with pytest.raises(ValueError, match="flagship"):
        make_fused_train_apply(UNet3D(port_config(
            ModelConfig(features=(16, 32), head_features=16))))


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _port_conv(fn, x, wt, r, dtype):
    """(y, dx, dw) of the port's conv with DHWIO weights, NDHWC arrays."""
    xt = _ncdhw(x).requires_grad_()
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(wt, (4, 3, 0, 1, 2)))).requires_grad_()
    y = fn(xt, w, dtype)
    (y.float() * _ncdhw(r)).sum().backward()
    assert xt.grad.dtype == xt.dtype and w.grad.dtype == w.dtype
    return (_ndhwc(y.float()), _ndhwc(xt.grad),
            np.transpose(w.grad.numpy(), (2, 3, 4, 1, 0)))


@pytest.mark.parametrize("ci", [1, 32, 64])
def test_conv3x3_matches_pallas_and_lax(ci):
    rng = np.random.default_rng(ci)
    n, w = 2, 64
    x = rng.normal(size=(n, 4, 8, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, 3, ci, 32)) * 0.2).astype(np.float32)
    r = rng.normal(size=(n, 4, 8, w, 32)).astype(np.float32)

    y_lax, vjp = jax.vjp(lambda a, b: xla_conv3x3(a, b, dtype=jnp.float32),
                         jnp.asarray(x), jnp.asarray(wt))
    want_lax = (y_lax, *vjp(jnp.asarray(r)))
    y_p, vjp = jax.vjp(lambda a, b: conv3x3_p2(a, b, w, True, "float32"),
                       pack2_w(jnp.asarray(x)), jnp.asarray(wt))
    dx_p, dw_p = vjp(pack2_w(jnp.asarray(r)))
    want_p = (unpack2_w(y_p, n, w), unpack2_w(dx_p, n, w), dw_p)

    for fn in (conv3x3, conv3x3_plain):
        got = _port_conv(fn, x, wt, r, "float32")
        for g, a, b in zip(got, want_lax, want_p):
            assert _rel_err(g, a) < 1e-4
            assert _rel_err(g, b) < 1e-4


def test_conv3x3_bf16_matches_pallas():
    """bf16 end to end (the TPU kernel's training dtype): forward within a
    bf16 ulp or two of the output scale; dx and dw at the 5% JAX's own
    custom_vjp test allows."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 8, 64, 16)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, 3, 16, 32)) * 0.2).astype(np.float32)
    r = rng.normal(size=(2, 4, 8, 64, 32)).astype(np.float32)
    xb = pack2_w(jnp.asarray(x)).astype(jnp.bfloat16)
    y_p, vjp = jax.vjp(lambda a, b: conv3x3_p2(a, b, 64, True),
                       xb, jnp.asarray(wt))
    dx_p, dw_p = vjp(pack2_w(jnp.asarray(r)).astype(jnp.bfloat16))
    want = (unpack2_w(y_p, 2, 64), unpack2_w(dx_p, 2, 64), dw_p)
    got = _port_conv(conv3x3, np.asarray(jnp.asarray(x, jnp.bfloat16),
                                          np.float32), wt, r, "bfloat16")
    assert _rel_err(got[0], want[0]) < 1e-2
    assert _rel_err(got[1], want[1]) < 5e-2
    assert _rel_err(got[2], want[2]) < 5e-2


def test_flip_w_matches():
    wt = np.random.default_rng(0).normal(size=(3, 3, 3, 5, 7)).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(wt, (4, 3, 0, 1, 2))))
    want = np.transpose(np.asarray(ref_flip_w(jnp.asarray(wt))), (4, 3, 0, 1, 2))
    np.testing.assert_array_equal(flip_w(w).numpy(), want)


def test_conv3x3_skips_dx_for_inputs_without_grad(monkeypatch):
    """enc0's input is the image: its backward runs the kernel once (the
    forward) and leaves dx to nobody."""
    calls = []
    raw = convtrain.conv3x3_raw

    def counting(x, w):
        calls.append(tuple(x.shape))
        return raw(x, w)

    monkeypatch.setattr(convtrain, "conv3x3_raw", counting)
    x = torch.randn(1, 1, 4, 5, 6)
    w = torch.randn(32, 1, 3, 3, 3, requires_grad=True)
    conv3x3(x, w, "float32").sum().backward()
    assert calls == [(1, 1, 4, 5, 6)] and w.grad is not None
    x.requires_grad_()
    conv3x3(x, w, "float32").sum().backward()
    assert calls[1:] == [(1, 1, 4, 5, 6), (1, 32, 4, 5, 6)]
    assert x.grad.shape == x.shape
