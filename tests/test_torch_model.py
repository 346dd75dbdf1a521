"""The port's U-Net, weight conversion and tile sweep == the JAX package's
(``tpuseg_torch/models``, ``ckpt``, ``infer/tiles.py``), with weights
carried across by ``port_state_from_jax``.

Tolerances: float32 logits agree to 1e-4 relative (plus 1e-5 absolute for
logits near 0) — both sides convolve in float32, summing in different
orders. bfloat16 logits agree to 2e-2 absolute: every layer rounds its
output to bf16 (8-bit mantissa, ~4e-3 relative), and XLA and PyTorch round
at slightly different points inside the fused BN/ReLU chain, so differences
of a few bf16 ulps of O(1) activations reach the heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ckpt.torch_import import (flax_variables_from_torch,
                                      torch_state_dict_from_flax)
from tpuseg.core import ModelConfig
from tpuseg.infer.tiles import tiled_forward as ref_tiled_forward
from tpuseg.models import build_model as ref_build_model
from tpuseg_torch.ckpt import load_pth, port_state_from_jax
from tpuseg_torch.core import config as port_config_module
from tpuseg_torch.infer.tiles import halo3, rf_radius_bound, tile_grid, tiled_forward
from tpuseg_torch.models import UNet3D, build_model

SMALL = dict(features=(8, 16, 32), head_features=8)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Test workers share the machine's cores: one torch intra-op thread
    each (several spinning thread pools per core slow every test ~10x).
    The other test_torch_* files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(cfg):
    """A config dataclass of the JAX package as the port's own class of the
    same name: the port's functions get the port's config (the two schemas
    are held together by tests/test_torch_config.py)."""
    import dataclasses

    cls = getattr(port_config_module, type(cfg).__name__)
    return port_config_module._build(cls, dataclasses.asdict(cfg))


def _randomized_variables(cfg, seed=0):
    """Flax variables (numpy) with random kernels, BN affines and BN
    statistics. The tree comes from the JAX package's own .pth importer,
    and ``model.apply`` checks it is complete."""
    rng = np.random.default_rng(seed)
    sd = UNet3D(port_config(cfg)).state_dict()
    variables = flax_variables_from_torch(sd)

    def rand(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['mean']"):
            return (rng.normal(size=shape) * 0.2).astype(np.float32)
        if name.endswith("['var']"):
            return (1.0 + 0.3 * rng.random(shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)   # biases

    return jax.tree_util.tree_map_with_path(rand, variables)


def _ref_apply(cfg, variables, x):
    return jax.jit(ref_build_model(cfg).apply)(
        jax.tree.map(jnp.asarray, variables), x)


def _port_model(cfg, variables):
    model = UNet3D(port_config(cfg))
    model.load_state_dict(port_state_from_jax(variables))
    return model.eval()


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5),
                                             ("bfloat16", 0.0, 2e-2)])
def test_unet_logits_match_flax(dtype, rtol, atol):
    cfg = ModelConfig(compute_dtype=dtype, **SMALL)
    variables = _randomized_variables(cfg)
    x = np.random.default_rng(1).random((2, 16, 16, 24, 1), np.float32)
    want = _ref_apply(cfg, variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(cfg, variables)(torch.from_numpy(x[..., 0]))
    for key in ("fg_logits", "peak_logits"):
        assert got[key].dtype == torch.float32
        assert got[key].shape == (2, 16, 16, 24)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=rtol, atol=atol)


def test_state_keys_match_mirror_export(tmp_path):
    """``load_pth`` takes the mirror-named .pth that tpuseg.cli.export
    writes; it holds exactly the port's state."""
    cfg = ModelConfig(compute_dtype="float32", **SMALL)
    variables = _randomized_variables(cfg, seed=2)
    path = str(tmp_path / "export.pth")
    torch.save(torch_state_dict_from_flax(variables), path)
    sd = load_pth(path)
    assert set(sd) == set(UNet3D(port_config(cfg)).state_dict())
    ref = port_state_from_jax(variables)
    for k, v in sd.items():
        assert torch.equal(v, ref[k]), k


def test_build_model_is_seeded():
    cfg = ModelConfig(**SMALL)
    cfg = port_config(cfg)
    a, b = build_model(cfg, seed=3), build_model(cfg, seed=3)
    c = build_model(cfg, seed=4)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not torch.equal(a.enc0.conv0.weight, c.enc0.conv0.weight)


def test_unported_model_config_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNet3D(port_config(ModelConfig(norm="group", **SMALL)))


def test_tile_helpers_match():
    from tpuseg.infer.tiles import halo3 as ref_halo3
    from tpuseg.infer.tiles import rf_radius_bound as ref_rf
    from tpuseg.infer.tiles import tile_grid as ref_grid

    assert halo3(5) == ref_halo3(5) and halo3((0, 2, 3)) == ref_halo3((0, 2, 3))
    assert [rf_radius_bound(n) for n in range(1, 7)] == [ref_rf(n) for n in range(1, 7)]
    np.testing.assert_array_equal(tile_grid((20, 33, 40), (8, 16, 16)),
                                  ref_grid((20, 33, 40), (8, 16, 16)))


@pytest.mark.parametrize("tile_batch", [1, 3])
def test_tiled_forward_matches_reference(tile_batch):
    """A real tile grid with a halo on a ragged volume, with the per-block
    preprocess; float32 at the model tolerance above."""
    cfg = ModelConfig(compute_dtype="float32", **SMALL)
    variables = _randomized_variables(cfg, seed=5)
    model = ref_build_model(cfg)
    vol = (np.random.default_rng(3).random((12, 26, 20)) * 3 + 1).astype(np.float32)
    kw = dict(tile=(8, 16, 16), halo=(4, 4, 8), tile_batch=tile_batch)

    def preprocess(b):
        return (b - 1.0) / 3.0

    want = ref_tiled_forward(model.apply,
                             jax.tree.map(jnp.asarray, variables),
                             jnp.asarray(vol), compute_dtype=jnp.float32,
                             preprocess=preprocess, **kw)
    with torch.no_grad():
        got = tiled_forward(_port_model(cfg, variables), torch.from_numpy(vol),
                            compute_dtype=torch.float32, preprocess=preprocess,
                            **kw)
    for key in ("fg_logits", "peak_logits"):
        assert got[key].shape == vol.shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-5)
