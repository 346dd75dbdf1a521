"""The tensor-core bodies of K6 and K4 (``tpuseg_torch/csrc/conv_mma.cuh``),
as far as the CPU can hold them: the kernels run only on the card
(``chip_smoke.py`` phases 6 and 10 hold them against their twins there).

* the weight packers of ``tpuseg_torch/ops/conv_mma.py``: layout, bf16
  rounding, round trip;
* a plain-torch model of the kernels' arithmetic that consumes the *packed*
  weights and the interleaved activation layout ([ci / 8][position][8],
  27 shifted matmuls, float32 accumulation, one rounding) against
  ``conv3x3_raw_plain`` and the JAX package's ``flat_conv3x3`` (interpret
  mode, as ``tests/unit/test_pallas_convtrain.py`` runs it);
* a model of K4's tile — conv1 over 64-position tiles of a flattened x
  window of pitch 18, T in the ring's layout of pitch 16, conv2 over its
  flattened tiles, the wrapped columns and the padding words poisoned with
  NaN — against ``fused_convblock_plain``;
* the body-selection rules, and ``conv3x3`` forward and dx on the CPU.

Tolerances. float32 models on bf16-representable inputs: products are exact,
only the order of the float32 sum differs: 1e-5 of the output's largest
magnitude. bfloat16: ``chip_smoke.check_conv`` / ``check_block``, the bounds
the card's kernels are held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuseg.ops.pallas_convtrain import flat_conv3x3, pack2_w, unpack2_w
from tpuseg_torch.ops.conv_mma import (mma_supported, pack_mma_weights,
                                       unpack_mma_weights)
from tpuseg_torch.ops.convblock import (block_bodies, fused_convblock,
                                        fused_convblock_plain, kernel_weights,
                                        pack_weights)
from tpuseg_torch.ops.convtrain import (conv3x3, conv3x3_raw,
                                        conv3x3_raw_plain, conv_body, flip_w)

from chip_smoke import check_block, check_conv
from test_torch_model import single_torch_thread  # noqa: F401

CI_CO = [(ci, co) for ci in (16, 32, 64) for co in (32, 64)]


def _bf16_values(rng, shape, scale=1.0):
    """float32 tensor whose values are bf16-representable."""
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)
    ).bfloat16().float()


def _tile(w):
    """(co, ci, 3, 3, 3) -> the (ci, 27, co) weight tile."""
    co, ci = w.shape[:2]
    return w.permute(1, 2, 3, 4, 0).reshape(ci, 27, co)


# ---- (a) the packers --------------------------------------------------------

@pytest.mark.parametrize("ci,co", CI_CO)
def test_pack_mma_weights_layout(ci, co):
    rng = np.random.default_rng(ci + co)
    w = torch.from_numpy(rng.standard_normal((co, ci, 3, 3, 3))
                         .astype(np.float32))
    wp = pack_mma_weights(_tile(w))
    assert wp.shape == (27, ci // 8, co, 8) and wp.dtype == torch.bfloat16
    assert wp.is_contiguous()
    # out[t, g, o, k] = bf16(w[o, 8g + k, kd, kh, kw]), t = (kd*3 + kh)*3 + kw
    for t, g, o, k in rng.integers(0, (27, ci // 8, co, 8), size=(50, 4)):
        kd, kh, kw = t // 9, t // 3 % 3, t % 3
        assert wp[t, g, o, k] == w[o, 8 * g + k, kd, kh, kw].bfloat16()
    # bf16 rounding is the only loss
    np.testing.assert_array_equal(
        wp.float().numpy(), pack_mma_weights(_tile(w.bfloat16())).float().numpy())


@pytest.mark.parametrize("ci,co", CI_CO)
def test_pack_mma_weights_round_trip(ci, co):
    rng = np.random.default_rng(ci * co)
    w = _bf16_values(rng, (co, ci, 3, 3, 3))
    back = unpack_mma_weights(pack_mma_weights(_tile(w)))
    assert back.shape == (ci, 27, co) and back.dtype == torch.float32
    torch_layout = back.reshape(ci, 3, 3, 3, co).permute(4, 0, 1, 2, 3)
    np.testing.assert_array_equal(torch_layout.numpy(), w.numpy())


def test_pack_mma_weights_refuses_other_shapes():
    with pytest.raises(ValueError):
        pack_mma_weights(torch.zeros(12, 27, 32))
    with pytest.raises(ValueError):
        pack_mma_weights(torch.zeros(16, 9, 32))


@pytest.mark.parametrize("ci", [32, 64])
def test_kernel_weights_forms(ci):
    """Every accepted weight form gives the same tensor-core tile, and the
    twin reads that tile back as the conv kernel it came from."""
    rng = np.random.default_rng(ci)
    w = torch.from_numpy(rng.standard_normal((32, ci, 3, 3, 3))
                         .astype(np.float32))
    from_torch = kernel_weights(w, "bfloat16", "mma")
    from_tile = kernel_weights(pack_weights(w, "bfloat16"), "bfloat16", "mma")
    assert from_torch.shape == (27, ci // 8, 32, 8)
    np.testing.assert_array_equal(from_torch.float().numpy(),
                                  from_tile.float().numpy())
    assert kernel_weights(from_torch, "bfloat16", "mma") is from_torch
    np.testing.assert_array_equal(
        kernel_weights(from_torch, "bfloat16", "fma").numpy(),
        pack_weights(w, "bfloat16").numpy())


# ---- (b) the arithmetic -----------------------------------------------------

def interleave(x):
    """(ci, Z, Y, X) -> the staged layout (ci / 8, Z, Y, X, 8)."""
    ci = x.shape[0]
    return x.reshape(ci // 8, 8, *x.shape[1:]).permute(0, 2, 3, 4, 1).contiguous()


def mma_conv_model(x, wp, dtype):
    """The tensor-core body's arithmetic in plain torch: per tap one matmul
    of the shifted, interleaved activations with that tap's packed weight
    slice, summed in float32, rounded once to ``dtype``."""
    n, ci, d, h, w = x.shape
    co = wp.shape[2]
    out = torch.empty((n, co, d, h, w), dtype=dtype)
    for i in range(n):
        xi = interleave(F.pad(x[i].float(), (1, 1, 1, 1, 1, 1)))
        acc = torch.zeros((d, h, w, co), dtype=torch.float32)
        for t in range(27):
            kd, kh, kw = t // 9, t // 3 % 3, t % 3
            a = xi[:, kd:kd + d, kh:kh + h, kw:kw + w]
            acc += torch.einsum("gdhwk,gok->dhwo", a, wp[t].float())
        out[i] = acc.permute(3, 0, 1, 2).to(dtype)
    return out


def _jax_flat_conv(x, w, dtype):
    """``flat_conv3x3`` in interpret mode on NCDHW torch x and (co, ci, 3,
    3, 3) w -> NCDHW float32 numpy."""
    n, width = x.shape[0], x.shape[-1]
    xj = jnp.asarray(x.float().permute(0, 2, 3, 4, 1).numpy()).astype(dtype)
    wj = jnp.asarray(w.float().permute(2, 3, 4, 1, 0).numpy())
    y = flat_conv3x3(pack2_w(xj), wj, valid_w=width, interpret=True,
                     compute_dtype=dtype)
    return np.moveaxis(np.asarray(unpack2_w(y, n, width), np.float32), -1, 1)


@pytest.mark.parametrize("ci,co", CI_CO)
def test_mma_model_matches_plain_and_pallas_f32(ci, co):
    rng = np.random.default_rng(ci + 7 * co)
    x = _bf16_values(rng, (2, ci, 3, 8, 64))
    w = _bf16_values(rng, (co, ci, 3, 3, 3), 0.2)
    got = mma_conv_model(x, pack_mma_weights(_tile(w)), torch.float32).numpy()
    want = conv3x3_raw_plain(x, w).numpy()
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * top
    assert np.abs(got - _jax_flat_conv(x, w, "float32")).max() <= 1e-5 * top


@pytest.mark.parametrize("ci,co", [(32, 32), (64, 32), (32, 64)])
def test_mma_model_matches_plain_and_pallas_bf16(ci, co):
    rng = np.random.default_rng(ci + co)
    x = _bf16_values(rng, (2, ci, 3, 8, 64)).bfloat16()
    w = _bf16_values(rng, (co, ci, 3, 3, 3), 0.2).bfloat16()
    got = mma_conv_model(x, pack_mma_weights(_tile(w)), torch.bfloat16)
    check_conv("model vs twin", got, conv3x3_raw_plain(x, w), torch.bfloat16)
    check_conv("model vs pallas", got,
               torch.from_numpy(_jax_flat_conv(x, w, "bfloat16")),
               torch.bfloat16)


def test_mma_model_dx_is_the_flipped_forward():
    """dx through the same body with ``flip_w`` weights (32 -> 64 channels,
    the co = 64 case of a train step)."""
    rng = np.random.default_rng(3)
    x = _bf16_values(rng, (1, 64, 3, 6, 9)).requires_grad_()
    w = _bf16_values(rng, (32, 64, 3, 3, 3), 0.2)
    dy = _bf16_values(rng, (1, 32, 3, 6, 9))
    (F.conv3d(x, w, padding=1) * dy).sum().backward()
    wf = flip_w(w).contiguous()
    assert wf.shape == (64, 32, 3, 3, 3)
    got = mma_conv_model(dy, pack_mma_weights(_tile(wf)), torch.float32)
    assert (got - x.grad).abs().max() <= 1e-5 * x.grad.abs().max()


# ---- K4's tile ----------------------------------------------------------------

OUT_Y, OUT_X = 8, 14          # output tile of a CTA
T_H, T_W = 10, 16             # T rows, and T's pitch
X_H, X_W = 12, 18             # staged x rows, and its pitch
T_WORDS, X_WORDS = 162, 230   # positions a channel group holds, padding included
NAN = float("nan")


def _flat_taps(src, pitch, tiles, wp, kd_planes):
    """sum over the 27 taps of (64 * tiles) consecutive positions of the
    flattened planes ``src[kd]`` ((groups, words, 8)) shifted by kh * pitch +
    kw, times the packed weights: (64 * tiles, co) float32."""
    m = 64 * tiles
    acc = torch.zeros((m, wp.shape[2]), dtype=torch.float32)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                off = kh * pitch + kw
                a = kd_planes(src, kd)[:, off:off + m]
                acc += torch.einsum("gpk,gok->po", a,
                                    wp[(kd * 3 + kh) * 3 + kw].float())
    return acc


def convblock_tile_model(x, w1p, s1, b1, w2p, s2, b2):
    """The bf16 tensor-core K4 kernel, tile by tile, in plain torch: x
    (ci, D, H, W) float32 holding bf16 values -> (32, D, H, W) bfloat16.
    Words the kernel never writes (the padding behind a plane) are NaN: only
    discarded rows may read them."""
    ci, d, h, w = x.shape
    out = torch.full((32, d, h, w), NAN).bfloat16()
    xpad = F.pad(x, (2, X_W, 2, X_H, 1, 1))  # zero outside the volume

    def x_window(z, ty0, tx0):
        win = xpad[:, z + 1, ty0:ty0 + X_H, tx0:tx0 + X_W]
        flat = torch.full((ci // 8, X_WORDS, 8), NAN)
        flat[:, :X_H * X_W] = interleave(win[:, None])[:, 0].reshape(
            ci // 8, X_H * X_W, 8)
        return flat

    for ty0 in range(0, h, OUT_Y):
        for tx0 in range(0, w, OUT_X):
            t_planes = {}
            for j in range(-1, d + 1):
                t = torch.full((4, T_WORDS, 8), NAN)
                t[:, :T_H * T_W] = 0.0
                if 0 <= j < d:
                    wins = [x_window(j - 1 + kd, ty0, tx0) for kd in range(3)]
                    acc = _flat_taps(wins, X_W, 3, w1p, lambda s, kd: s[kd])
                    for p in range(64 * 3):
                        row, col = divmod(p, X_W)
                        if row >= T_H or col >= T_W:
                            continue
                        gy, gx = ty0 - 1 + row, tx0 - 1 + col
                        if 0 <= gy < h and 0 <= gx < w:
                            v = torch.relu(acc[p] * s1 + b1).bfloat16().float()
                            t[:, row * T_W + col] = v.reshape(4, 8)
                t_planes[j] = t
            for z in range(d):
                acc = _flat_taps(t_planes, T_W, 2, w2p,
                                 lambda s, kd: s[z - 1 + kd])
                for p in range(64 * 2):
                    row, col = divmod(p, T_W)
                    gy, gx = ty0 + row, tx0 + col
                    if col < OUT_X and gy < h and gx < w:
                        out[:, z, gy, gx] = torch.relu(
                            acc[p] * s2 + b2).bfloat16()
    return out


@pytest.mark.parametrize("ci,shape", [(32, (3, 10, 17)), (64, (2, 9, 15)),
                                      (32, (1, 3, 5))])
def test_convblock_tile_model_matches_twin(ci, shape):
    rng = np.random.default_rng(ci + shape[0])
    x = _bf16_values(rng, (ci, *shape))
    w1 = _bf16_values(rng, (32, ci, 3, 3, 3), 0.2)
    w2 = _bf16_values(rng, (32, 32, 3, 3, 3), 0.2)
    s1, s2 = (torch.from_numpy((rng.standard_normal(32) * 0.3 + 1.0)
                               .astype(np.float32)) for _ in range(2))
    b1, b2 = (torch.from_numpy((rng.standard_normal(32) * 0.3)
                               .astype(np.float32)) for _ in range(2))
    bodies = block_bodies(torch.bfloat16, ci)
    assert bodies == ("mma", "mma")
    w1p = kernel_weights(w1, "bfloat16", bodies[0])
    w2p = kernel_weights(w2, "bfloat16", bodies[1])
    got = convblock_tile_model(x, w1p, s1, b1, w2p, s2, b2)
    assert not torch.isnan(got.float()).any()      # no padding word leaked
    want = fused_convblock_plain(x[None], w1, s1, b1, w2, s2, b2, "bfloat16")[0]
    check_block("tile model vs twin", got, want, torch.bfloat16)
    # the wrapper takes the re-laid weights too (the CPU path is the twin)
    again = fused_convblock(x[None], w1p, s1, b1, w2p, s2, b2, "bfloat16")[0]
    np.testing.assert_array_equal(again.float().numpy(), want.float().numpy())


# ---- (c) which body runs ------------------------------------------------------

@pytest.mark.parametrize("dtype,ci,co,body", [
    (torch.bfloat16, 32, 32, "mma"), (torch.bfloat16, 64, 32, "mma"),
    (torch.bfloat16, 32, 64, "mma"), (torch.bfloat16, 16, 32, "mma"),
    (torch.bfloat16, 16, 64, "mma"),
    (torch.bfloat16, 1, 32, "fma"), (torch.bfloat16, 32, 1, "fma"),
    (torch.bfloat16, 24, 32, "fma"), (torch.bfloat16, 32, 48, "fma"),
    (torch.bfloat16, 48, 32, "fma"), (torch.bfloat16, 128, 16, "fma"),
    (torch.bfloat16, 64, 64, "fma"),      # weights beyond one block's memory
    (torch.float32, 32, 32, "fma"), (torch.float32, 64, 32, "fma"),
    (torch.float32, 1, 32, "fma"),
])
def test_conv_body_rule(dtype, ci, co, body):
    assert conv_body(dtype, ci, co) == body
    if dtype == torch.bfloat16:
        assert mma_supported(ci, co) == (body == "mma")


@pytest.mark.parametrize("dtype,ci,bodies", [
    (torch.bfloat16, 1, ("fma", "mma")), (torch.bfloat16, 32, ("mma", "mma")),
    (torch.bfloat16, 64, ("mma", "mma")), (torch.bfloat16, 16, ("fma", "mma")),
    (torch.bfloat16, 96, ("fma", "mma")),
    (torch.float32, 1, ("fma", "fma")), (torch.float32, 32, ("fma", "fma")),
    (torch.float32, 64, ("fma", "fma")),
])
def test_block_bodies_rule(dtype, ci, bodies):
    assert block_bodies(dtype, ci) == bodies


# ---- (d) conv3x3 on the CPU ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_forward_and_dx_on_cpu(dtype):
    """On a CPU tensor the wrapper takes the twin whatever the body rule
    says, counts no launch, and dx is the forward on ``flip_w`` weights."""
    rng = np.random.default_rng(11)
    x = _bf16_values(rng, (2, 32, 3, 6, 9)).requires_grad_()
    w = _bf16_values(rng, (32, 32, 3, 3, 3), 0.2).requires_grad_()
    dy = _bf16_values(rng, (2, 32, 3, 6, 9))
    before = (conv3x3_raw.launches, conv3x3_raw.mma_launches)
    y = conv3x3(x, w, dtype)
    (y.float() * dy).sum().backward()
    assert (conv3x3_raw.launches, conv3x3_raw.mma_launches) == before
    tdt = getattr(torch, dtype)
    assert y.dtype == tdt and x.grad.dtype == torch.float32
    want_y = conv3x3_raw_plain(x.detach().to(tdt), w.detach().to(tdt))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  want_y.float().numpy())
    want_dx = conv3x3_raw(dy.to(tdt), flip_w(w.detach().to(tdt)).contiguous())
    np.testing.assert_array_equal(x.grad.numpy(), want_dx.float().numpy())
    model_dx = mma_conv_model(dy, pack_mma_weights(_tile(flip_w(w.detach()))),
                              tdt)
    check_conv("dx model", model_dx, want_dx, tdt)
