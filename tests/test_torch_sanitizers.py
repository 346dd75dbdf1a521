"""Numerical sanitizers of the port (the counterpart of
``tests/unit/test_sanitizers.py``): the train step runs clean under
``torch.autograd.set_detect_anomaly(True)`` (any NaN produced in the
backward raises at the op that made it) with every gradient finite, and
the public ops keep their shape and dtype contracts."""

import numpy as np
import pytest
import torch

from tpuseg_torch.core import (Config, DataConfig, ModelConfig,
                               TrainConfig)
from tpuseg_torch.data import PatchSampler, synthesize_volume
from tpuseg_torch.models import build_model
from tpuseg_torch.ops import (connected_components, label_sizes, peak_nms,
                              seed_labels_from_peaks, size_filter, watershed)
from tpuseg_torch.train import create_train_state, make_train_step

from test_torch_model import single_torch_thread  # noqa: F401


@pytest.mark.parametrize("norm,activation", [("batch", "relu"),
                                             ("group", "gelu")])
def test_train_step_clean_under_anomaly_detection(norm, activation):
    cfg = Config(
        model=ModelConfig(features=(4, 8), num_groups=2, head_features=4,
                          norm=norm, activation=activation,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(16, 16, 16), batch_size=2,
                        max_instances=8),
        train=TrainConfig(total_steps=2, warmup_steps=1, lr=1e-3),
    )
    vol = synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=0)
    model = build_model(cfg.model)
    state = create_train_state(model, cfg)
    sampler = PatchSampler([vol], patch_size=cfg.data.patch_size,
                           batch_size=2, max_instances=8, seed=0)
    step = make_train_step(model, cfg)
    grads = {}
    update = state.opt.update

    def seen_update(params, g, gnorm):     # the gradients the optimizer gets
        grads.update(g)
        return update(params, g, gnorm)

    state.opt.update = seen_update
    with torch.autograd.set_detect_anomaly(True):
        for _ in range(2):
            batch = {k: torch.from_numpy(v)
                     for k, v in sampler.next_batch().items()}
            grads.clear()
            metrics = step(state, batch, 1)
            assert all(np.isfinite(float(v)) for v in metrics.values())
            assert grads.keys() == dict(model.named_parameters()).keys()
            for name, g in grads.items():
                assert torch.isfinite(g).all(), name
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())


def test_op_contracts():
    vol = torch.zeros((8, 8, 8))
    seeds = peak_nms(vol + 0.6, threshold=0.5, radius=1)
    assert seeds.dtype == torch.bool and seeds.shape == (8, 8, 8)

    lab = watershed(vol, vol)
    assert lab.dtype == torch.int32 and lab.shape == (8, 8, 8)
    for impl in ("xla", "pallas"):
        s = seed_labels_from_peaks(vol + 0.6, 0.5, 1, nms_impl=impl)
        assert s.dtype == torch.int32 and s.shape == (8, 8, 8)
        assert int((s > 0).sum()) == int(seeds.sum())
        assert label_sizes(s).dtype == torch.int32
        assert size_filter(s, 2).dtype == torch.int32
    xla = watershed(vol + 0.9, vol + 0.9, resolve_impl="xla", ascent_rounds=1)
    assert xla.dtype == torch.int32 and xla.shape == (8, 8, 8)

    cc = connected_components(vol > 1.0)
    assert cc.dtype == torch.int32 and int(cc.max()) == 0
