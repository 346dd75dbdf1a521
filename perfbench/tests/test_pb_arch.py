"""The U-Net behind the architecture seam (``arch/unet3d.py``) is the net the
harness made and checked before the seam: the same state names, shapes and
draw, the same reference forward and tile sweep; and a mix that names no
generator is made by the nuclei generator, bit for bit."""

import hashlib

import pytest
import torch

from perfbench import cells, gen
from perfbench.reference import unet

TINY = {"in_channels": 1, "features": [8, 16], "head_features": 8,
        "compute_dtype": "float32", "param_dtype": "float32"}
FULL = {"in_channels": 1, "features": [32, 64, 128, 256],
        "head_features": 32}
#: sha256 over (name, shape, bytes) of the state the harness drew before
#: the seam (``weights.init_state``, on the CPU)
BEFORE = {("tiny", 3): "10b4bb8e958f29444607a246b581e5028b868f82"
                       "099fbb3c186b109a6e55bac4",
          ("full", 42): "0976578525438e7d0a9437ff39ff3151e67353b6"
                        "1a7fc3b7ba4d22f0f6002f8e"}


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("which,seed", sorted(BEFORE))
def test_unet_state_as_before(which, seed):
    arch = cells.load_arch("unet3d")
    model = {"tiny": TINY, "full": FULL}[which]
    state = arch.init_state(model, seed, "cpu")
    assert list(state) == list(arch.state_shapes(model))
    assert _digest(state) == BEFORE[(which, seed)]


def _state(seed):
    state = cells.load_arch("unet3d").init_state(TINY, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for k, v in state.items():      # statistics and affines off (0, 1)
        if v.dim() == 1:
            state[k] = v + 0.1 * torch.rand(v.shape, generator=g)
    return state


@pytest.mark.parametrize("train", [False, True])
def test_unet_forward_is_the_references(train):
    arch = cells.load_arch("unet3d")
    x = torch.rand(2, 8, 16, 16, generator=torch.Generator().manual_seed(4))
    p, q = _state(5), _state(5)
    s_p = {k: v for k, v in p.items() if arch.is_statistic(k)}
    s_q = {k: v for k, v in q.items() if arch.is_statistic(k)}
    assert s_p and all("running" in k for k in s_p)
    got = arch.forward(p, x, TINY, train=train, stats=s_p if train else None)
    want = unet.forward(q, x, len(TINY["features"]), train=train,
                        stats=s_q if train else None)
    for k in want:
        assert torch.equal(got[k], want[k])
    for k in s_p:
        assert torch.equal(s_p[k], s_q[k])


def test_tile_sweep_of_a_forward():
    """One tile over the whole volume with no halo is one forward pass; a
    grid of tiles whose halo covers the net's reach gives the same cores."""
    arch = cells.load_arch("unet3d")
    p = _state(6)
    vol = torch.rand(8, 24, 20, generator=torch.Generator().manual_seed(7))

    def fwd(x):
        return arch.forward(p, x, TINY)

    def pre(b):
        return b * 2.0

    with torch.no_grad():
        whole = fwd(pre(vol)[None])
        one = unet.tiled_logits(fwd, vol, (8, 24, 20), (0, 0, 0), pre)
    for k in whole:
        assert torch.equal(one[k], whole[k][0])


def test_unet_work_and_flops_are_work_pys():
    from perfbench import work

    arch = cells.load_arch("unet3d")
    assert arch.flops_per_voxel(FULL) == work.unet_flops_per_voxel() \
        == 619328
    assert arch.work(FULL, "infer", shape=(96, 512, 512),
                     tile=(96, 256, 512), halo=(0, 8, 0)) \
        == {"k4": work.k4_work(FULL, (96, 512, 512), (96, 256, 512),
                               (0, 8, 0))}
    assert arch.work(FULL, "train", batch=8, patch=(64, 64, 64)) \
        == {"k6": work.k6_work(FULL, 8, (64, 64, 64))}
    assert arch.program_overrides(FULL) == {
        "model.in_channels": 1, "model.features": [32, 64, 128, 256],
        "model.head_features": 32}


def test_configurations_without_arch_are_the_unet():
    for c in cells.benchmark()["configs"]:
        data = cells.load_json(cells.ROOT / c["file"])
        assert "arch" not in data and cells.arch_name(data) == "unet3d"
    with pytest.raises(FileNotFoundError):
        cells.load_arch("no-such-net")


#: sha256 over (image, centres, half-sizes) of each volume that
#: ``gen.make_volumes`` made before the generators were looked up by name
#: (on the CPU), on :func:`test_nuclei_mix_is_make_volumes`'s
#: group and seed
NUCLEI_BEFORE = ("780cfbf92e37a5b7a764d70d5330e1515c174e15b0f7c8057b"
                 "055e7b5bbdcfa1")


def test_nuclei_mix_is_make_volumes():
    """``stack600.json`` names no generator, so ``volumes_for`` takes the
    ``nuclei`` generator's ``make_volumes``: bit for bit the volumes made
    before the lookup, on its group cut to a CPU test's shape and count."""
    p = dict(cells.load_json(cells.HERE / "traffic" / "stack600.json")
             ["volumes"])
    assert gen.generator(p) == "nuclei"
    p.update(shape=[24, 96, 96], count=2, nuclei=30)
    got = gen.volumes_for(p, 2 ** 31 + 5, "cpu")
    assert len(got) == 2
    h = hashlib.sha256()
    for v in got:
        for a in (v.image.numpy(), v.centers, v.half_sizes):
            h.update(a.tobytes())
    assert h.hexdigest() == NUCLEI_BEFORE
