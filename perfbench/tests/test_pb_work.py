"""The work counts against a hand count and against the program's U-Net:
its convolutions, their widths and the resolution each runs at, and the
state dict the benchmark draws."""

import pytest
import torch

from perfbench import cells, work

MODEL = {"in_channels": 1, "features": [32, 64, 128, 256],
         "head_features": 32}


def test_flops_per_voxel_by_hand():
    f, head = (32, 64, 128, 256), 32
    block = lambda ci, co, s: 2 * 27 * (ci * co + co * co) / s  # noqa: E731
    total = block(1, 32, 1) + block(64, 64, 8) + block(128, 128, 64)
    total += sum(2 * 8 * f[i] * f[i + 1] / 8 ** (i + 1) for i in range(3))
    total += block(256, 256, 512)
    total += sum(2 * 8 * f[i + 1] * f[i] / 8 ** i
                 + 2 * 27 * 3 * f[i] * f[i] / 8 ** i for i in range(3))
    total += block(32, head, 1) + 2 * 2 * head
    assert work.unet_flops_per_voxel() == total == 619328


def test_convs_match_the_programs_unet():
    """Every Conv3d of ``tpuseg_torch.models.UNet3D``: its name, kernel,
    widths, and the level its output runs at (from a forward pass)."""
    from tpuseg_torch.core import ModelConfig
    from tpuseg_torch.models import UNet3D

    model = UNet3D(ModelConfig(compute_dtype="float32")).eval()
    seen = {}

    def hook(name):
        def fn(mod, inp, out):
            seen[name] = (mod.kernel_size[0], mod.in_channels,
                          mod.out_channels, out.shape[2:].numel())
        return fn

    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv3d):
            mod.register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.zeros(1, 1, 16, 16, 16))
    ours = {n: (k, ci, co, 16 ** 3 // 8 ** lvl)
            for n, k, ci, co, lvl in work.unet_convs()}
    assert ours == seen


def test_state_dict_matches_the_programs():
    from tpuseg_torch.core import ModelConfig
    from tpuseg_torch.models import UNet3D

    arch = cells.load_arch("unet3d")
    want = {k: tuple(v.shape) for k, v in
            UNet3D(ModelConfig()).state_dict().items()}
    assert arch.state_shapes(MODEL) == want
    state = arch.init_state(MODEL, 3, "cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    UNet3D(ModelConfig()).load_state_dict(state)
    again = arch.init_state(MODEL, 3, "cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)


@pytest.mark.parametrize("shape,blocks", [((96, 512, 512), 2),
                                          ((192, 1024, 1024), 16)])
def test_k4_work_by_hand(shape, blocks):
    flops, nbytes = work.k4_work(MODEL, shape, (96, 256, 512), (0, 8, 0))
    vox = 96 * 272 * 512
    per_voxel = 2 * 27 * (1 * 32 + 32 * 32 + 64 * 32 + 32 * 32
                          + 32 * 32 + 32 * 32)
    assert flops == blocks * vox * per_voxel
    weights_b = 27 * (32 + 1024 + 2048 + 1024 + 1024 + 1024) * 2
    assert nbytes == blocks * (vox * (1 + 32 + 64 + 32 + 32 + 32) * 2
                               + weights_b)


def test_k6_work_by_hand():
    flops, nbytes = work.k6_work(MODEL, 8, (64, 64, 64))
    vox = 8 * 64 ** 3
    fwd = [(1, 32), (32, 32), (64, 32), (32, 32), (32, 32), (32, 32)]
    dx = [(32, 32), (32, 64), (32, 32), (32, 32), (32, 32)]
    assert flops == vox * sum(2 * 27 * a * b for a, b in fwd + dx)
    assert nbytes == 2 * sum(vox * (a + b) + 27 * a * b for a, b in fwd + dx)
    # the six forwards are the fused train apply's full-resolution convs
    assert [(ci, co) for n, k, ci, co, lvl in work.unet_convs()
            if k == 3 and lvl == 0] == fwd


def test_roofline_takes_the_larger_bound():
    assert work.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert work.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)
