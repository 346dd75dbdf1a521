"""The peak-NMS kernel's path (K5) of the port, ``tpuseg_torch/ops/nms.py``
and the watershed compositions it selects (``ops/watershed.py``) == the JAX
package's, elementwise, on the same numpy maps.

On the CPU the wrapper ``fused_peak_nms`` takes its plain twin; the JAX
kernel runs as its own tests run it (``force_tpu_interpret_mode``). The CUDA
kernel is held against the same twin on the card (``chip_smoke.py`` phases
11 and 12). Seed masks and labels are integers: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpuseg.ops.pallas_nms import pallas_peak_nms
from tpuseg.ops.peaks import peak_nms as ref_peak_nms
from tpuseg.ops.watershed import watershed as ref_watershed
from tpuseg_torch.ops import peak_nms, watershed
from tpuseg_torch.ops.nms import fused_peak_nms, fused_peak_nms_plain
from tpuseg_torch.ops.nms_cases import (CHAIN_RADII, SMALL_SHAPE, THRESHOLD,
                                        TILE_RADII, adversarial_maps,
                                        expected_constant_seeds)

from test_torch_model import single_torch_thread  # noqa: F401
from test_torch_ops import _maps

SHAPE = (16, 128, 64)       # the TPU kernel's blocks (8, 64) divide it


def _cases():
    rng = np.random.default_rng(0)
    yield "random", rng.random(SHAPE).astype(np.float32)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE],
                             indexing="ij")
    blobs = np.zeros(SHAPE, np.float32)
    for c in [(4, 30, 30), (12, 100, 40), (8, 64, 10)]:
        blobs = np.maximum(blobs, np.exp(
            -((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 18.0))
    yield "blobs", blobs
    plateau = np.zeros(SHAPE, np.float32)
    plateau[6:9, 40:44, 20:24] = 0.9    # exact ties exercise the tie-break
    plateau[7:10, 62:66, 0:3] = 0.9     # across the TPU kernel's block seam
    yield "plateau", plateau
    yield "quantized", np.round(rng.random(SHAPE) * 4).astype(np.float32) / 4


@pytest.mark.parametrize("radius", [1, 2, (1, 2, 2), (2, 1, 2)])
def test_fused_peak_nms_matches_pallas_and_xla(radius):
    with pltpu.force_tpu_interpret_mode():
        for name, vol in _cases():
            got = fused_peak_nms(torch.from_numpy(vol), 0.5, radius)
            assert got.dtype == torch.bool and got.shape == SHAPE, name
            assert 0 < int(got.sum()) < got.numel(), name
            for ref in (pallas_peak_nms, ref_peak_nms):
                want = np.asarray(ref(jnp.asarray(vol), 0.5, radius))
                assert np.array_equal(got.numpy(), want), (name, ref.__name__)


def test_fused_peak_nms_takes_shapes_the_tpu_kernel_falls_back_on():
    """(10, 100, 60) and a zero radius on an axis: the TPU wrapper falls
    back to XLA there; the port has one path for every shape."""
    vol = np.random.default_rng(1).random((10, 100, 60)).astype(np.float32)
    for radius in (2, (0, 2, 1)):
        want = np.asarray(ref_peak_nms(jnp.asarray(vol), 0.5, radius))
        got = fused_peak_nms(torch.from_numpy(vol), 0.5, radius)
        assert np.array_equal(got.numpy(), want)


def test_fused_peak_nms_twin_is_the_plain_nms():
    assert fused_peak_nms_plain is peak_nms
    assert fused_peak_nms.launches == 0         # no kernel for a CPU tensor
    assert fused_peak_nms.tile_launches == 0


# the inputs a tiled NMS can get wrong (the CUDA kernel's tile is (32, 32) in
# (y, x) with a 2r halo): the twin the kernel is held to on the card must
# itself equal the JAX package there. (6, 70, 140) is wider than one tile on
# both axes; SMALL_SHAPE is below one, with rz >= D.


@pytest.mark.parametrize("radius", TILE_RADII + CHAIN_RADII)
@pytest.mark.parametrize("shape", [(6, 70, 140), SMALL_SHAPE])
def test_fused_peak_nms_adversarial_maps_match_xla(shape, radius):
    for name, peak, _ in adversarial_maps(shape, seed=4):
        want = np.asarray(ref_peak_nms(jnp.asarray(peak), THRESHOLD, radius))
        got = fused_peak_nms(torch.from_numpy(peak), THRESHOLD, radius)
        assert np.array_equal(got.numpy(), want), name
        if name == "constant":
            assert np.array_equal(want, expected_constant_seeds(shape, radius))
            assert want.sum() == 1 or min(radius) == 0
        else:
            assert 0 < want.sum() < want.size, name


@pytest.mark.parametrize("radius", [(2, 2, 2), (1, 2, 2), (3, 1, 4)])
def test_fused_peak_nms_adversarial_maps_match_pallas(radius):
    """The same maps through the TPU kernel in interpret mode, at a shape its
    (8, 64) blocks divide and the CUDA tile does not."""
    shape = (8, 128, 40)
    with pltpu.force_tpu_interpret_mode():
        for name, peak, _ in adversarial_maps(shape, seed=5):
            want = np.asarray(pallas_peak_nms(jnp.asarray(peak), THRESHOLD,
                                              radius))
            got = fused_peak_nms(torch.from_numpy(peak), THRESHOLD, radius)
            assert np.array_equal(got.numpy(), want), name


KW = dict(peak_threshold=0.5, fg_threshold=0.4, flood_iters=48)


@pytest.mark.parametrize("radius", [2, (1, 2, 2)])
@pytest.mark.parametrize("method,nms_impl", [("ascent", "pallas"),
                                             ("flood", "xla"),
                                             ("flood", "pallas")])
def test_watershed_settings_match_reference(method, nms_impl, radius):
    """``nms_impl="pallas"`` (K5's composition) and ``method="flood"``
    against the JAX ``watershed`` under the same settings; the plain twins
    give the same labels."""
    fg_prob, peak = _maps(3, (16, 32, 40))
    peak[5:7, 10:13, 20:22] = peak.max()           # a plateau seed
    kw = dict(method=method, nms_impl=nms_impl, peak_radius=radius, **KW)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_watershed(jnp.asarray(fg_prob),
                                        jnp.asarray(peak), **kw))
    fg_t, pk_t = torch.from_numpy(fg_prob), torch.from_numpy(peak)
    got = watershed(fg_t, pk_t, **kw)
    assert got.dtype == torch.int32 and want.max() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(watershed(fg_t, pk_t, plain=True, **kw), got)


@pytest.mark.parametrize("seed", [3, 4])
def test_watershed_nms_kernel_path_equals_default_path(seed):
    fg_prob, peak = _maps(seed, (16, 32, 40))
    fg_t, pk_t = torch.from_numpy(fg_prob), torch.from_numpy(peak)
    default = watershed(fg_t, pk_t, **KW)
    assert int(default.max()) > 0
    assert torch.equal(watershed(fg_t, pk_t, nms_impl="pallas", **KW), default)
    # a flood from the seeds labels what the ascent labels, by other routes
    flood = watershed(fg_t, pk_t, method="flood", **KW)
    assert torch.equal(flood > 0, default > 0)
    assert torch.equal(flood.unique(), default.unique())
