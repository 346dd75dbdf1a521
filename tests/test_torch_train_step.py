"""The port's train step (``tpuseg_torch/train/step.py``) == the JAX
package's ``make_train_step`` on the same weights and batches, with
augmentation off (torch cannot reproduce JAX's PRNG stream; the augment
apply half is held to JAX in ``test_torch_train_data.py``).

Flagship family at test size, float32. Tolerances:

* loss and grad_norm: 3e-4 relative (summation order; BatchNorm's backward
  amplifies it in the gradients, and by the third step the parameters
  below have drifted apart a little);
* parameters after the updates: each tensor's update (new minus initial)
  within 5% relative L2 error of JAX's (measured: under 2.1%), and no
  element more than 2 lr per step off. Adam normalizes every element —
  its early updates are ~lr * sign(g) — so an element whose gradient sits
  at the rounding floor can take a full step on one side only, and
  elementwise agreement is not to be had;
* running statistics: the same 5% bound on each tensor's change (they
  follow the parameters, which drift apart as above over three steps);
* the schedule and the optimizer alone: 1e-6 relative (float32 rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuseg.core import Config, DataConfig, ModelConfig, TrainConfig
from tpuseg.models import build_model as ref_build_model
from tpuseg.train.step import TrainState as RefTrainState
from tpuseg.train.step import make_optimizer as ref_make_optimizer
from tpuseg.train.step import make_train_step as ref_make_train_step
from tpuseg.train.step import prepare_batch as ref_prepare_batch
from tpuseg_torch.ckpt import jax_variables_from_port
from tpuseg_torch.data import PatchSampler, synthesize_volume
from tpuseg_torch.train import (AdamW, create_train_state, lr_schedule,
                                make_train_step, prepare_batch)

from test_torch_model import (_port_model, _randomized_variables, port_config,
                              single_torch_thread)  # noqa: F401


def _cfg(apply_impl="flax", batch=2, augment=False, **train):
    return Config(
        model=ModelConfig(features=(32, 64), head_features=32,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(8, 16, 64), batch_size=batch,
                        max_instances=8, augment=augment),
        train=TrainConfig(total_steps=10, warmup_steps=2, lr=1e-3,
                          apply_impl=apply_impl, **train),
    )


def _batches(n, batch=2):
    vol = synthesize_volume(shape=(16, 32, 64), num_instances=4, seed=2)
    s = PatchSampler([vol], patch_size=(8, 16, 64), batch_size=batch,
                     max_instances=8, seed=0)
    return [s.next_batch() for _ in range(n)]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _run_both(cfg, batches, monkeypatch, grad_accum=1, seed=3):
    variables = _randomized_variables(cfg.model, seed=seed)
    # JAX side
    model = ref_build_model(cfg.model)
    tx = ref_make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = RefTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray,
                                                   variables["batch_stats"]),
                          opt_state=tx.init(params), tx=tx)
    if cfg.train.apply_impl == "fused":
        import tpuseg.models.fused_train as ft

        orig = ft.make_fused_train_apply
        monkeypatch.setattr(ft, "make_fused_train_apply",
                            lambda m, **kw: orig(m, interpret=True, **kw))
    ref_step = jax.jit(ref_make_train_step(model, cfg, grad_accum=grad_accum))
    ref_metrics = []
    for b in batches:
        state, m = ref_step(state, b, jax.random.key(1))
        ref_metrics.append({k: float(v) for k, v in m.items()})
    # the port
    pmodel = _port_model(cfg.model, variables)
    pstate = create_train_state(pmodel, port_config(cfg))
    step = make_train_step(pmodel, port_config(cfg), grad_accum=grad_accum)
    metrics = [{k: float(v) for k, v in step(
        pstate, {k: torch.from_numpy(v) for k, v in b.items()}, 1).items()}
        for b in batches]
    assert pstate.step == len(batches) == int(state.step)
    return (metrics, jax_variables_from_port(pmodel.state_dict())), (
        ref_metrics, {"params": state.params, "batch_stats": state.batch_stats},
        variables)


def _compare(got, want, lr=1e-3):
    (metrics, variables), (ref_metrics, ref_vars, init) = got, want
    for m, r in zip(metrics, ref_metrics):
        assert m.keys() == r.keys()
        for k in m:
            np.testing.assert_allclose(m[k], r[k], rtol=3e-4, err_msg=k)
    for coll in ("params", "batch_stats"):
        g, w = _leaves(variables[coll]), _leaves(ref_vars[coll])
        p0 = _leaves(init[coll])
        assert g.keys() == w.keys() == p0.keys()
        for k in g:
            d = np.abs(g[k] - w[k])
            if coll == "params":
                assert d.max() <= 2 * lr * len(metrics), (k, d.max())
            moved = np.linalg.norm(w[k] - p0[k])
            assert np.linalg.norm(g[k] - w[k]) <= 0.05 * moved, k


@pytest.mark.parametrize("apply_impl,n_steps", [("flax", 1), ("flax", 3),
                                                ("fused", 1)])
def test_train_steps_match_jax(apply_impl, n_steps, monkeypatch):
    cfg = _cfg(apply_impl)
    _compare(*_run_both(cfg, _batches(n_steps), monkeypatch))


def test_grad_accum_matches_jax(monkeypatch):
    """grad_accum=2: microbatch gradients averaged, BatchNorm statistics
    carried from the first microbatch into the second."""
    cfg = _cfg(batch=4)
    _compare(*_run_both(cfg, _batches(1, batch=4), monkeypatch, grad_accum=2))


def test_prepare_batch_matches_jax():
    cfg = _cfg(peak_loss_weight=1.0)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, peak_sigma_aniso=True))
    b = _batches(1)[0]
    img, tgt = prepare_batch({k: torch.from_numpy(v) for k, v in b.items()},
                             port_config(cfg), 1, 0)
    want_img, want_tgt = ref_prepare_batch(
        {k: jnp.asarray(v) for k, v in b.items()}, cfg, jax.random.key(0))
    np.testing.assert_array_equal(img.numpy(), np.asarray(want_img)[..., 0])
    np.testing.assert_allclose(tgt["peak"].numpy(), np.asarray(want_tgt["peak"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("fg", "fg_weight"):
        np.testing.assert_array_equal(tgt[k].numpy(), np.asarray(want_tgt[k]))


def test_augmentation_keyed_on_global_example_index():
    """Augmented prepare_batch is a pure function of (seed, step, example
    index): the same call repeats, and two half batches at offsets 0 and 2
    reproduce the whole batch (what grad accumulation relies on)."""
    cfg = _cfg(batch=4, augment=True)
    cfg = port_config(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, aug_zscale=(0.5, 1.0))))
    b = {k: torch.from_numpy(v) for k, v in _batches(1, batch=4)[0].items()}
    img, tgt = prepare_batch(b, cfg, 5, 7)
    again, _ = prepare_batch(b, cfg, 5, 7)
    assert torch.equal(img, again)
    halves = [prepare_batch({k: v[o:o + 2] for k, v in b.items()}, cfg, 5, 7,
                            example_offset=o) for o in (0, 2)]
    assert torch.equal(torch.cat([h[0] for h in halves]), img)
    for k in tgt:
        assert torch.equal(torch.cat([h[1][k] for h in halves]), tgt[k])
    other, _ = prepare_batch(b, cfg, 5, 8)
    assert not torch.equal(other, img)


@pytest.mark.parametrize("warmup,total", [(20, 200), (5, 5), (0, 10)])
def test_schedule_matches_optax(warmup, total):
    tc = TrainConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    want = optax.warmup_cosine_decay_schedule(
        init_value=tc.lr / max(warmup, 1), peak_value=tc.lr,
        warmup_steps=warmup, decay_steps=max(total, warmup + 1))
    got = lr_schedule(tc)
    for count in sorted({0, max(warmup - 1, 0), warmup, total // 2, total,
                         total + 3}):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_adamw_matches_optax(scale):
    """Three updates on random parameters and gradients, unclipped
    (global norm < 1) and clipped."""
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tc = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.1)
    tx = ref_make_optimizer(Config(train=tc))
    p_ref = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(p_ref)
    p_port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    adam = AdamW(p_port, tc)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        gt = {k: torch.from_numpy(v) for k, v in g.items()}
        adam.update(p_port, gt, torch.sqrt(sum((v ** 2).sum()
                                               for v in gt.values())))
        for k in shapes:
            np.testing.assert_allclose(p_port[k].numpy(), np.asarray(p_ref[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert adam.count == 3
