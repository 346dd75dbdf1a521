"""The fused eval ConvBlock (K4) of the port, ``tpuseg_torch/ops/convblock.py``
== ``tpuseg/ops/pallas_convblock.py`` on the same numpy inputs.

On the CPU the wrapper ``fused_convblock`` takes its plain twin, which is
what these tests hold against the JAX package's XLA reference
(``reference_convblock``) and against the Pallas kernel itself in interpret
mode (``fused_convblock_chw(interpret=True)``); the CUDA kernel is held
against the same twin on the card (``chip_smoke.py`` phase 10).

Tolerances. float32: every element within 1e-4 of the output's largest
magnitude — all three accumulate in float32 and differ in summation order
only. bfloat16: the two sides sum conv1 in different orders, so now and then
an element of the intermediate T rounds to the neighbouring bf16 value, and
conv2 carries that to the outputs in reach, which is more than 2 ulps of an
output near zero; so every element within 2 bf16 ulps of the output's
largest magnitude, and at least 99.5% within 2 ulps of their own magnitude
(floored at 2^-8 of the largest).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops.pallas_convblock import fold_bn_affine as ref_fold_bn_affine
from tpuseg.ops.pallas_convblock import fused_convblock_chw, reference_convblock
from tpuseg_torch.ops.convblock import (fold_bn_affine, fused_convblock,
                                        fused_convblock_plain, pack_weights)

from chip_smoke import bf16_ulp
from test_torch_model import single_torch_thread  # noqa: F401

CO = 32


def _inputs(shape, ci, seed=0):
    """x (D, H, W, ci) and the block's weights in the JAX layout
    (3, 3, 3, ci, co), non-zero affines (b1 != 0 shows a T that is not zero
    outside the volume)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, ci)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 3, ci, CO)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 3, CO, CO)) * 0.2).astype(np.float32)
    s1, s2 = ((rng.standard_normal(CO) * 0.3 + 1.0).astype(np.float32)
              for _ in range(2))
    b1, b2 = ((rng.standard_normal(CO) * 0.3).astype(np.float32)
              for _ in range(2))
    return x, (w1, s1, b1, w2, s2, b2)


def _port(x, mats, dtype, fn=fused_convblock):
    """The port's block on (D, H, W, ci) numpy input -> (D, H, W, co)."""
    w1, s1, b1, w2, s2, b2 = (torch.from_numpy(m) for m in mats)
    out = fn(torch.from_numpy(x).permute(3, 0, 1, 2)[None],
             w1.permute(4, 3, 0, 1, 2), s1, b1,
             w2.permute(4, 3, 0, 1, 2), s2, b2, dtype)
    assert out.dtype == getattr(torch, dtype)
    return out[0].permute(1, 2, 3, 0).float().numpy()


def _assert_close(got, want, dtype):
    assert got.shape == want.shape
    top = np.abs(want).max()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 1e-4 * top, (err.max(), top)
        return
    ulp = bf16_ulp(torch.from_numpy(np.maximum(np.abs(want), top * 2.0 ** -8)))
    assert err.max() <= 2 * float(bf16_ulp(torch.tensor(top))), (err.max(), top)
    assert (err <= 2 * ulp.numpy()).mean() >= 0.995


CASES = [  # the cases of tests/unit/test_pallas_convblock.py, and bf16 ci=1/64
    ((6, 16, 40), 32, "float32"),
    ((5, 8, 24), 1, "float32"),       # enc0: a single input channel
    ((4, 8, 24), 64, "float32"),      # up0.block: 64 channels after the concat
    ((1, 8, 24), 32, "float32"),      # D = 1: both z taps outside the volume
    ((3, 8, 37), 32, "float32"),      # odd W
    ((2, 3, 150), 32, "float32"),     # W > 128 and no multiple of it
    ((6, 16, 40), 32, "bfloat16"),
    ((5, 8, 24), 1, "bfloat16"),
    ((4, 8, 24), 64, "bfloat16"),
]


@pytest.mark.parametrize("shape,ci,dtype", CASES)
def test_convblock_matches_xla_reference(shape, ci, dtype):
    x, mats = _inputs(shape, ci)
    want = reference_convblock(jnp.asarray(x), *map(jnp.asarray, mats),
                               compute_dtype=dtype)
    _assert_close(_port(x, mats, dtype), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("shape,ci,dtype", CASES)
def test_convblock_matches_pallas_interpret(shape, ci, dtype):
    x, mats = _inputs(shape, ci, seed=1)
    want = fused_convblock_chw(jnp.asarray(x).transpose(0, 3, 1, 2),
                               *map(jnp.asarray, mats), interpret=True,
                               compute_dtype=dtype).transpose(0, 2, 3, 1)
    _assert_close(_port(x, mats, dtype), np.asarray(want, np.float32), dtype)


def test_convblock_border_is_padded_with_zero_T():
    """conv2's SAME padding pads T with zeros. Evaluating conv1 on the
    zero-padded input instead gives relu(b1) around the volume and moves the
    whole border shell: the twin must not agree with that."""
    x, mats = _inputs((3, 4, 5), 32, seed=2)
    w1, s1, b1, w2, s2, b2 = mats
    b1 = np.abs(b1) + 0.5
    got = _port(x, (w1, s1, b1, w2, s2, b2), "float32")
    xp = np.pad(x, ((1, 1), (1, 1), (1, 1), (0, 0)))
    wrong = np.asarray(reference_convblock(
        jnp.asarray(xp), *map(jnp.asarray, (w1, s1, b1, w2, s2, b2)),
        compute_dtype="float32"))[1:-1, 1:-1, 1:-1]
    want = np.asarray(reference_convblock(
        jnp.asarray(x), *map(jnp.asarray, (w1, s1, b1, w2, s2, b2)),
        compute_dtype="float32"))
    _assert_close(got, want, "float32")
    assert np.abs(got - wrong).max() > 0.05 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convblock_batch_and_packed_weights(dtype):
    """A batch of N blocks is N results (to the module's tolerance: the
    library conv sums a batch in another order than a single sample);
    weights packed once by ``pack_weights`` give the same bits as
    torch-layout weights; the wrapper on a CPU tensor is the twin."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 3, 6, 9)).astype(np.float32))
    _, mats = _inputs((1, 1, 1), 32, seed=3)
    w1, s1, b1, w2, s2, b2 = (torch.from_numpy(m) for m in mats)
    w1, w2 = w1.permute(4, 3, 0, 1, 2), w2.permute(4, 3, 0, 1, 2)
    both = fused_convblock(x, w1, s1, b1, w2, s2, b2, dtype)
    assert both.shape == (2, CO, 3, 6, 9)
    for i in range(2):
        one = fused_convblock(x[i:i + 1], w1, s1, b1, w2, s2, b2, dtype)
        _assert_close(both[i].float().numpy(), one[0].float().numpy(), dtype)
    packed = fused_convblock(x, pack_weights(w1, dtype), s1, b1,
                             pack_weights(w2, dtype), s2, b2, dtype)
    assert torch.equal(packed, both)
    assert torch.equal(fused_convblock_plain(x, w1, s1, b1, w2, s2, b2, dtype),
                       both)
    assert fused_convblock.launches == 0        # no kernel for a CPU tensor


def test_pack_weights_layout():
    w = torch.arange(2 * 3 * 27, dtype=torch.float32).reshape(2, 3, 3, 3, 3)
    wk = pack_weights(w, "float32")
    assert wk.shape == (3, 27, 2) and wk.dtype == torch.float32
    assert wk[1, (2 * 3 + 0) * 3 + 1, 0] == w[0, 1, 2, 0, 1]
    # values are rounded to the compute dtype before they are widened
    fine = torch.full((1, 1, 3, 3, 3), 1.0 + 2.0 ** -10)
    assert torch.all(pack_weights(fine, "bfloat16") == 1.0)
    with pytest.raises(ValueError, match="pack_weights"):
        pack_weights(torch.zeros(2, 3, 3, 3), "float32")


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_fold_bn_affine_matches_jax(eps):
    rng = np.random.default_rng(3)
    bn = {"mean": rng.standard_normal(CO).astype(np.float32),
          "var": (rng.random(CO) + 0.1).astype(np.float32),
          "scale": rng.standard_normal(CO).astype(np.float32),
          "bias": rng.standard_normal(CO).astype(np.float32)}
    want_s, want_b = ref_fold_bn_affine(bn, eps=eps)
    s, b = fold_bn_affine(*(torch.from_numpy(bn[k])
                            for k in ("scale", "bias", "mean", "var")), eps=eps)
    assert s.dtype == b.dtype == torch.float32
    # float32 rsqrt against the float64 fold rounded to float32
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
    np.testing.assert_allclose(b.numpy(), np.asarray(want_b), rtol=1e-5,
                               atol=1e-6)
