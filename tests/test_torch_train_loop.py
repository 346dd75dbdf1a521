"""The port's training loop, checkpoints and CLI (``tpuseg_torch/train/
loop.py``, ``ckpt/manager.py``, ``cli/train.py``): exact resume, prefetch
equal to synchronous feeding, the JSONL metrics, validation with the
best checkpoint, and the trainer checkpoint read by ``cli.infer``. These
compare the port with itself (the JAX loop's Orbax checkpoints and its
PRNG differ by design); parity of the step is in
``test_torch_train_step.py``. The runs are deterministic on the CPU, so
repeated runs agree exactly."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpuseg_torch.ckpt import (CheckpointManager, jax_variables_from_port,
                               load_pth, port_state_from_jax)
from tpuseg_torch.cli import infer as cli_infer
from tpuseg_torch.cli import train as cli_train
from tpuseg_torch.core import Config, DataConfig, ModelConfig, TrainConfig
from tpuseg_torch.data import synthesize_volume
from tpuseg_torch.models import UNet3D
from tpuseg_torch.train import train

from test_torch_model import _randomized_variables, single_torch_thread  # noqa: F401


def tiny_config(ckpt_dir, steps=6, **train_kw):
    train_kw = {"warmup_steps": 2, "log_every": 2, "ckpt_every": 3,
                "lr": 1e-3, **train_kw}
    return Config(
        model=ModelConfig(features=(4, 8), head_features=4,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(16, 16, 16), batch_size=2,
                        max_instances=8),
        train=TrainConfig(total_steps=steps, ckpt_dir=str(ckpt_dir),
                          **train_kw),
    )


@pytest.fixture(scope="module")
def vols():
    return [synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=s)
            for s in (0, 9)]


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_loss_decreases_and_jsonl_written(vols, tmp_path):
    cfg = tiny_config(tmp_path / "ck", steps=30, lr=3e-3)
    log = tmp_path / "m.jsonl"
    _, history = train(cfg, vols[:1], log_path=str(log), device="cpu")
    losses = [h["loss"] for h in history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    lines = [json.loads(line) for line in open(log)]
    assert len(lines) == 15
    assert {"step", "wall_s", "loss", "peak_loss", "fg_loss", "grad_norm",
            "mvox_per_s"} <= set(lines[0])


def test_resume_matches_uninterrupted(vols, tmp_path):
    state_a, _ = train(tiny_config(tmp_path / "a"), vols[:1], device="cpu")
    train(tiny_config(tmp_path / "b", steps=3), vols[:1], device="cpu")
    state_b, _ = train(tiny_config(tmp_path / "b"), vols[:1], resume=True,
                       device="cpu")
    assert state_b.step == state_a.step == 6
    _assert_same(_params(state_a), _params(state_b))
    assert state_a.opt.count == state_b.opt.count == 6


def test_prefetch_matches_synchronous(vols, tmp_path):
    runs = [train(tiny_config(tmp_path / f"p{d}", prefetch_depth=d),
                  vols[:1], device="cpu") for d in (0, 2)]
    _assert_same(_params(runs[0][0]), _params(runs[1][0]))
    assert runs[0][1][-1]["loss"] == runs[1][1][-1]["loss"]


def test_grad_accum_runs_and_differs_only_by_bn_coupling(vols, tmp_path):
    """grad_accum=2 draws the same augmentations (keyed on the global
    example index) and moves the parameters close to the unaccumulated
    step; BatchNorm statistics per microbatch are the only difference."""
    base = tiny_config(tmp_path / "g1", steps=2, ckpt_every=100)
    s1, _ = train(base, vols[:1], device="cpu")
    s2, _ = train(dataclasses.replace(base, train=dataclasses.replace(
        base.train, grad_accum=2, ckpt_dir=str(tmp_path / "g2"))),
        vols[:1], device="cpu")
    num = den = 0.0
    with torch.no_grad():
        for a, b in zip(s1.model.parameters(), s2.model.parameters()):
            num += float(((a - b) ** 2).sum())
            den += float((a ** 2).sum())
    assert 0.0 < (num / den) ** 0.5 < 0.02


def test_val_metrics_and_best_checkpoint(vols, tmp_path):
    cfg = tiny_config(tmp_path / "ck", val_fraction=0.5, val_every=3,
                      val_patches=4, val_f1=True)
    _, history = train(cfg, vols, log_path=str(tmp_path / "m.jsonl"),
                       device="cpu")
    val = [h for h in history if "val_loss" in h]
    assert [h["step"] for h in val] == [3, 6]
    assert all(np.isfinite(h["val_loss"]) for h in val)
    assert {"val_fg_loss", "val_peak_loss", "val_center_f1"} <= set(val[0])
    best = CheckpointManager(str(tmp_path / "ck" / "best"))
    assert best.latest_step() in (3, 6)
    _, _, meta, _ = best.restore()
    assert meta["val_loss"] == min(h["val_loss"] for h in val)


def test_checkpoint_manager_keep_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    model = UNet3D(ModelConfig(features=(4, 8), head_features=4))
    params = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    for step in (1, 2, 3):
        mgr.save(step, params, {"count": step, "mu": {}, "nu": {}},
                 {"step": step, "best_val": float("inf")}, stats)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    p, opt, meta, bs = mgr.restore()
    assert opt["count"] == 3 and meta["step"] == 3
    _assert_same({k: v.detach() for k, v in params.items()}, p)
    _assert_same(stats, bs)
    _assert_same(load_pth(mgr.model_path()),
                 {k: v.detach() for k, v in model.state_dict().items()})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_jax_variables_round_trip():
    cfg = ModelConfig(features=(8, 16), head_features=8)
    variables = _randomized_variables(cfg, seed=1)
    back = jax_variables_from_port(port_state_from_jax(variables))
    got = {jax.tree_util.keystr(p): v
           for p, v in jax.tree_util.tree_leaves_with_path(back)}
    want = {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(variables)}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_cli_train_then_infer_from_checkpoint_dir(tmp_path, capsys):
    ck = tmp_path / "ck"
    overrides = ["--set", "model.features=[4,8]", "--set",
                 "model.head_features=4", "--set", "data.patch_size=[16,16,16]",
                 "--set", "data.batch_size=2", "--set", "train.total_steps=2",
                 "--set", "train.log_every=1", "--set", f"train.ckpt_dir={json.dumps(str(ck))}"]
    cli_train.main(["--device", "cpu", "--synthetic", "1", *overrides])
    assert "done: step 2" in capsys.readouterr().out
    assert CheckpointManager(str(ck)).latest_step() == 2
    assert json.load(open(ck / "config.json"))["model"]["features"] == [4, 8]
    vol = tmp_path / "v.npy"
    np.save(vol, synthesize_volume(shape=(16, 32, 32), num_instances=3).image)
    out = tmp_path / "o.npy"
    status = cli_infer.main(["--device", "cpu", "--checkpoint", str(ck),
                             "--input", str(vol), "--output", str(out),
                             "--set", "model.features=[4,8]", "--set",
                             "model.head_features=4", "--set",
                             "infer.tile=[16,32,32]", "--set", "infer.halo=4"])
    assert status == 0 and np.load(out).shape == (16, 32, 32)


def test_cli_train_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--synthetic", "1", "--set",
                        f"train.ckpt_dir={json.dumps(str(tmp_path))}"])


def test_cli_train_file_inputs(tmp_path):
    from tpuseg_torch.data import save_annotations

    sv = synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=1)
    np.save(tmp_path / "img.npy", sv.image)
    save_annotations(str(tmp_path / "ann.npz"), sv.centers, sv.half_sizes)
    ck = tmp_path / "ck"
    cli_train.main(["--device", "cpu", "--image", str(tmp_path / "img.npy"),
                    "--annotations", str(tmp_path / "ann.npz"),
                    "--set", "model.features=[4,8]", "--set",
                    "model.head_features=4", "--set",
                    "data.patch_size=[16,16,16]", "--set", "data.batch_size=2",
                    "--set", "train.total_steps=1", "--set",
                    f"train.ckpt_dir={json.dumps(str(ck))}"])
    assert os.path.exists(CheckpointManager(str(ck)).model_path())
