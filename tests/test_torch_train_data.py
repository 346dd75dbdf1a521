"""The port's training data side (``tpuseg_torch/data``: sampler, per-patch
normalization, weak targets, augmentation; ``train/val.split_volumes``) ==
the JAX package's on the same numpy inputs.

Sampler batches, splits, masks and per-patch percentiles are compared
exactly (the same numpy code, or the same float32 arithmetic). The peak
target agrees to 1e-6: ``exp`` is XLA's polynomial on one side and the
C library's on the other. Augmentation is compared on its apply half with
the parameters JAX draws from a key (torch cannot reproduce JAX's PRNG).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.data.augment import augment_patch as ref_augment
from tpuseg.data.augment import zscale_patch as ref_zscale
from tpuseg.data.normalize import histogram_percentile_normalize as ref_normalize
from tpuseg.data.sampler import PatchSampler as RefSampler
from tpuseg.data.synthetic import synthesize_volume as ref_synth
from tpuseg.data.weak_targets import make_weak_targets as ref_targets
from tpuseg.train.val import split_volumes as ref_split
from tpuseg_torch.data import (PatchSampler, histogram_percentile_normalize,
                               make_weak_targets, synthesize_volume)
from tpuseg_torch.data.augment import (apply_augment, apply_zscale,
                                       draw_augment_params, draw_zscale)
from tpuseg_torch.train.val import split_volumes

from test_torch_model import single_torch_thread  # noqa: F401

PATCH = (8, 16, 24)


@pytest.fixture(scope="module")
def vols():
    kw = dict(shape=(20, 40, 48), num_instances=8, radius_range=(2.0, 5.0))
    return ([synthesize_volume(seed=s, **kw) for s in (0, 1)],
            [ref_synth(seed=s, **kw) for s in (0, 1)])


@pytest.fixture(scope="module")
def batch(vols):
    return PatchSampler(vols[0], patch_size=PATCH, batch_size=3,
                        max_instances=6, seed=2).next_batch()


def test_sampler_batches_bit_identical(vols):
    port = PatchSampler(vols[0], patch_size=PATCH, batch_size=3,
                        max_instances=6, seed=5)
    ref = RefSampler(vols[1], patch_size=PATCH, batch_size=3,
                     max_instances=6, seed=5)
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state_dict() == ref.state_dict()
    port.load_state_dict({"seed": 5, "step": 1})
    ref.load_state_dict({"seed": 5, "step": 1})
    np.testing.assert_array_equal(port.next_batch()["image"],
                                  ref.next_batch()["image"])


def test_sampler_keeps_source_dtype(vols):
    v = vols[0][0]
    v8 = type(v)(image=(v.image * 255).astype(np.uint8), labels=v.labels,
                 centers=v.centers, half_sizes=v.half_sizes)
    b = PatchSampler([v8], patch_size=PATCH, batch_size=2).next_batch()
    assert b["image"].dtype == np.uint8 and b["valid"].dtype == bool
    assert b["centers"].dtype == np.float32


@pytest.mark.parametrize("n_vols,frac", [(5, 0.4), (2, 0.5), (1, 0.25)])
def test_split_volumes_bit_identical(n_vols, frac):
    kw = dict(shape=(40, 24, 24), num_instances=6)
    port_v = [synthesize_volume(seed=s, **kw) for s in range(n_vols)]
    ref_v = [ref_synth(seed=s, **kw) for s in range(n_vols)]
    (ptr, pva), (rtr, rva) = (split_volumes(port_v, frac, seed=3),
                              ref_split(ref_v, frac, seed=3))
    for p_list, r_list in ((ptr, rtr), (pva, rva)):
        assert len(p_list) == len(r_list)
        for p, r in zip(p_list, r_list):
            for f in ("image", "labels", "centers", "half_sizes"):
                np.testing.assert_array_equal(getattr(p, f), getattr(r, f))


def test_split_single_volume_too_shallow_raises():
    vol = synthesize_volume(shape=(12, 24, 24), num_instances=2)
    with pytest.raises(ValueError, match="single-volume split"):
        split_volumes([vol], 0.25, min_depth=8)


def test_per_patch_normalize_matches(batch):
    img = batch["image"] * 3.0 + 1.0
    got = histogram_percentile_normalize(torch.from_numpy(img)).numpy()
    for i in range(img.shape[0]):
        want = np.asarray(ref_normalize(jnp.asarray(img[i])))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("aniso", [False, True])
def test_weak_targets_match(batch, aniso):
    kw = dict(peak_sigma=2.5, margin=1.5, aniso_sigma=aniso)
    got = make_weak_targets(torch.from_numpy(batch["centers"]),
                            torch.from_numpy(batch["half_sizes"]),
                            torch.from_numpy(batch["valid"]), PATCH,
                            chunk=4, **kw)
    for i in range(batch["image"].shape[0]):
        want = ref_targets(jnp.asarray(batch["centers"][i]),
                           jnp.asarray(batch["half_sizes"][i]),
                           jnp.asarray(batch["valid"][i]), PATCH, **kw)
        np.testing.assert_allclose(got["peak"][i].numpy(),
                                   np.asarray(want["peak"]),
                                   rtol=1e-6, atol=1e-6)
        for k in ("fg", "fg_weight"):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]))
    assert got["fg"].sum() > 0 and (got["fg_weight"] == 0).any()


def _jax_augment_params(key, shape):
    """The parameters ``augment_patch`` draws from ``key``."""
    k_flip, k_swap, k_scale, k_shift, k_noise = jax.random.split(key, 5)
    t = lambda a: torch.from_numpy(np.array(a))      # noqa: E731
    return {
        "flips": t(jax.random.bernoulli(k_flip, 0.5, (3,))),
        "swap": t(jax.random.bernoulli(k_swap, 0.5)),
        "scale": t(1.0 + 0.2 * jax.random.uniform(k_scale, minval=-1.0,
                                                  maxval=1.0)),
        "shift": t(0.1 * jax.random.uniform(k_shift, minval=-1.0,
                                             maxval=1.0)),
        "noise": t(0.02 * jax.random.normal(k_noise, shape)),
    }


@pytest.mark.parametrize("seed,shape", [(0, (6, 12, 12)), (3, (6, 12, 12)),
                                        (7, (6, 10, 12))])
def test_augment_apply_matches(seed, shape):
    rng = np.random.default_rng(seed)
    image = rng.random(shape, np.float32)
    tgts = {k: rng.random(shape, np.float32) for k in ("peak", "fg")}
    key = jax.random.key(seed)
    want_img, want_t = ref_augment(key, jnp.asarray(image),
                                   {k: jnp.asarray(v) for k, v in tgts.items()})
    got_img, got_t = apply_augment(_jax_augment_params(key, shape),
                                   torch.from_numpy(image),
                                   {k: torch.from_numpy(v) for k, v in tgts.items()})
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=1e-6, atol=1e-7)
    for k in tgts:
        np.testing.assert_array_equal(got_t[k].numpy(), np.asarray(want_t[k]))


@pytest.mark.parametrize("lo,hi", [(0.5, 1.0), (1.0, 1.6)])
def test_zscale_apply_matches(batch, lo, hi):
    key = jax.random.key(11)
    img = batch["image"][0]
    args = (batch["centers"][0], batch["half_sizes"][0], batch["valid"][0])
    want = ref_zscale(key, jnp.asarray(img), *map(jnp.asarray, args), (lo, hi))
    s = torch.tensor(np.asarray(jax.random.uniform(key, minval=lo, maxval=hi)))
    got = apply_zscale(s, torch.from_numpy(img),
                       *(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_draws_are_seeded_and_in_range():
    shape = (4, 8, 8)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return draw_augment_params(g, shape), draw_zscale(g, (0.5, 1.0))

    (a, sa), (b, sb), (c, _) = draw(1), draw(1), draw(2)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(sa, sb) and 0.5 <= float(sa) < 1.0
    assert not torch.equal(a["noise"], c["noise"])
    assert a["flips"].shape == (3,) and a["flips"].dtype == torch.bool
    assert 0.8 <= float(a["scale"]) <= 1.2 and -0.1 <= float(a["shift"]) <= 0.1
    assert a["noise"].shape == shape and float(a["noise"].std()) < 0.05
