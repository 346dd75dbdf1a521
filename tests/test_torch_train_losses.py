"""The port's losses (``tpuseg_torch/losses``) == the JAX package's: values
and the gradients with respect to the logits, on the same numpy inputs.

Both sides compute in float32 and sum in different orders: values agree
to 1e-5 relative, gradients to 1e-5 relative plus 1e-9 absolute (the
gradients are O(1 / voxels))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import TrainConfig
from tpuseg.losses import fg_loss as ref_fg_loss
from tpuseg.losses import peak_loss as ref_peak_loss
from tpuseg.losses import total_loss as ref_total_loss
from tpuseg_torch.losses import fg_loss, peak_loss, total_loss

from test_torch_model import port_config, single_torch_thread  # noqa: F401

SHAPE = (3, 6, 10, 12)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    return {
        "fg_logits": (rng.normal(size=SHAPE) * 3).astype(np.float32),
        "peak_logits": (rng.normal(size=SHAPE) * 3).astype(np.float32),
        "peak": rng.random(SHAPE, np.float32) ** 4,
        "fg": (rng.random(SHAPE) < 0.3).astype(np.float32),
        "fg_weight": (rng.random(SHAPE) < 0.8).astype(np.float32),
    }


def _grad(fn, x):
    t = torch.from_numpy(x.copy()).requires_grad_()
    v = fn(t)
    v.backward()
    return v.detach().numpy(), t.grad.numpy()


def test_peak_loss_matches(case):
    got, g = _grad(lambda t: peak_loss(t, torch.from_numpy(case["peak"])).sum(),
                   case["peak_logits"])
    want, gw = jax.value_and_grad(lambda x: jnp.sum(jax.vmap(ref_peak_loss)(
        x, jnp.asarray(case["peak"]))))(jnp.asarray(case["peak_logits"]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(g, np.asarray(gw), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("dice_weight", [0.0, 0.5])
def test_fg_loss_matches(case, dice_weight):
    tgt = torch.from_numpy(case["fg"])
    w = torch.from_numpy(case["fg_weight"])
    got, g = _grad(lambda t: fg_loss(t, tgt, w, dice_weight).sum(),
                   case["fg_logits"])

    def ref(x):
        return jnp.sum(jax.vmap(lambda a, b, c: ref_fg_loss(
            a, b, c, dice_weight=dice_weight))(
            x, jnp.asarray(case["fg"]), jnp.asarray(case["fg_weight"])))

    want, gw = jax.value_and_grad(ref)(jnp.asarray(case["fg_logits"]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(g, np.asarray(gw), rtol=1e-5, atol=1e-9)


def test_fg_loss_ignores_zero_weight(case):
    w = torch.from_numpy(case["fg_weight"])
    t = torch.from_numpy(case["fg_logits"].copy()).requires_grad_()
    fg_loss(t, torch.from_numpy(case["fg"]), w).sum().backward()
    assert torch.all(t.grad[w == 0] == 0)


def test_total_loss_matches(case):
    cfg = TrainConfig(peak_loss_weight=0.7, fg_loss_weight=1.3, dice_weight=0.4)
    logits = {k: torch.from_numpy(case[k].copy()).requires_grad_()
              for k in ("fg_logits", "peak_logits")}
    tgts = {k: torch.from_numpy(case[k]) for k in ("peak", "fg", "fg_weight")}
    loss, metrics = total_loss(logits, tgts, port_config(cfg))
    loss.backward()

    def ref(out):
        return ref_total_loss(out, {k: jnp.asarray(case[k])
                                    for k in ("peak", "fg", "fg_weight")}, cfg)

    (want, wm), gw = jax.value_and_grad(ref, has_aux=True)(
        {k: jnp.asarray(case[k]) for k in ("fg_logits", "peak_logits")})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for k in ("loss", "peak_loss", "fg_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]), rtol=1e-5)
    for k, t in logits.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gw[k]),
                                   rtol=1e-5, atol=1e-9)
