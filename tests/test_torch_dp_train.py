"""The port's data-parallel training (``tpuseg_torch/train/dp.py``, the
step's ``axis_name``, the synced BatchNorm, the loop and ``cli.train``)
in two real localhost processes on gloo, against the single-process port
step on the same examples and against the JAX package's
``make_dp_train_step`` on a 2-device mesh
(``tests/distributed/test_dp_train.py`` and the reference worker's leg B).

Tolerances are the reference's: a DP step equals the single-device step
within ``rtol=1e-3, atol=1e-5`` (the BatchNorm statistics' and gradients'
sums run in another order); the fused apply's population bound, more than
99.9% of the parameters' elements close and none more than 2.5 lr off;
against JAX (whose
PRNG stream the port cannot reproduce, so with augmentation off) the bounds
of ``test_torch_train_step.py``. The workers run this file as a script
(``test_torch_multihost.run_workers``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_multihost import (assert_reference_blocked, block_reference,
                                  run_processes, run_workers)

SMALL = dict(features=(4, 8), head_features=4, compute_dtype="float32")
FUSED = dict(features=(32, 64), head_features=32, compute_dtype="float32")
LR = 1e-3


def port_cfg(model, patch, batch, augment, **train):
    from tpuseg_torch.core import Config, DataConfig, ModelConfig, TrainConfig

    return Config(model=ModelConfig(**model),
                  data=DataConfig(patch_size=patch, batch_size=batch,
                                  max_instances=8, augment=augment),
                  train=TrainConfig(lr=LR, warmup_steps=1, total_steps=4,
                                    **train))


def small_cfg(augment):
    return port_cfg(SMALL, (16, 16, 16), 8, augment)


def fused_cfg():
    return port_cfg(FUSED, (8, 16, 64), 4, True, apply_impl="fused")


def _model(cfg, state_path):
    from tpuseg_torch.models import UNet3D

    model = UNet3D(cfg.model)
    model.load_state_dict(torch.load(state_path, weights_only=True))
    return model.train()


def _state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


# ---------------------------------------------------------------- workers


def _worker_dp(tmp: str) -> None:
    """A DP step with and without augmentation, three steps in sync, the
    fused apply's step, the synced BatchNorm's gradients, and the loop's
    refusal of a batch the processes do not divide."""
    import torch.distributed as dist

    from tpuseg_torch.models.blocks import train_batch_norm
    from tpuseg_torch.parallel.multihost import initialize, process_index
    from tpuseg_torch.train import (create_train_state, make_data_mesh,
                                    make_dp_train_step, shard_batch, train)

    assert initialize(device="cpu")
    rank = process_index()
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    out = {}
    mesh = make_data_mesh(device="cpu")
    assert mesh.local_ranks() == [rank]
    for aug in (True, False):
        cfg = small_cfg(aug)
        model = _model(cfg, os.path.join(tmp, "small.pt"))
        state = create_train_state(model, cfg)
        step = make_dp_train_step(model, cfg, mesh)
        for i in range(3 if aug else 1):
            batch = {k[3:]: inp[k] for k in inp.files
                     if k.startswith(f"b{i}_")}
            m = step(state, shard_batch(batch, mesh), 1)
            for k, v in m.items():
                out[f"aug{int(aug)}_step{i}_{k}"] = np.array(float(v))
            for k, v in _state(model).items():
                out[f"aug{int(aug)}_step{i}/{k}"] = v

    cfg = fused_cfg()
    model = _model(cfg, os.path.join(tmp, "fused.pt"))
    state = create_train_state(model, cfg)
    step = make_dp_train_step(model, cfg, mesh)
    batch = {k[2:]: inp[k] for k in inp.files if k.startswith("f_")}
    m = step(state, shard_batch(batch, mesh), 1)
    out["fused_loss"] = np.array(float(m["loss"]))
    for k, v in _state(model).items():
        out[f"fused/{k}"] = v

    # the synced BatchNorm on this rank's half of the batch
    half = inp["bn_x"].shape[0] // 2
    sl = slice(rank * half, (rank + 1) * half)
    x = torch.from_numpy(inp["bn_x"][sl]).requires_grad_()
    w = torch.from_numpy(inp["bn_w"]).requires_grad_()
    b = torch.from_numpy(inp["bn_b"]).requires_grad_()
    rm, rv = torch.zeros(w.shape), torch.ones(w.shape)
    y = train_batch_norm(x, w, b, rm, rv, group=dist.group.WORLD)
    (y * torch.from_numpy(inp["bn_g"][sl])).sum().backward()
    out.update(bn_y=y.detach().numpy(), bn_dx=x.grad.numpy(),
               bn_dw=w.grad.numpy(), bn_db=b.grad.numpy(), bn_rm=rm.numpy(),
               bn_rv=rv.numpy())

    from tpuseg_torch.data import synthesize_volume

    vol = synthesize_volume(shape=(16, 32, 32), num_instances=3, seed=0)
    with pytest.raises(ValueError, match="does not divide over 2"):
        train(port_cfg(SMALL, (8, 16, 16), 3, False), [vol], device="cpu")
    assert_reference_blocked()
    np.savez(os.path.join(tmp, f"dp_rank{rank}.npz"), **out)


def _worker_world1(tmp: str) -> None:
    """A group of one (``TPUSEG_DIST_BACKEND``): the DP step through the
    group equals the plain step bitwise, and sharded labels come out of
    the backend's collectives."""
    import torch.distributed as dist

    from chip_smoke import AnalyticNet
    from tpuseg_torch.infer import make_sharded_infer_fn, shard_volume, unshard
    from tpuseg_torch.parallel import Mesh
    from tpuseg_torch.parallel.mesh import place_shards
    from tpuseg_torch.parallel.multihost import backend, initialize
    from tpuseg_torch.train import (create_train_state, make_data_mesh,
                                    make_dp_train_step, make_train_step,
                                    shard_batch)

    from test_torch_multihost import port_cfg as infer_cfg

    assert initialize(device="cpu") is False
    assert dist.get_world_size() == 1 and backend() == "gloo"
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    batch = {k[3:]: inp[k] for k in inp.files if k.startswith("b0_")}
    cfg = small_cfg(True)
    states = []
    for grouped in (True, False):
        model = _model(cfg, os.path.join(tmp, "small.pt"))
        state = create_train_state(model, cfg)
        if grouped:
            mesh = make_data_mesh(device="cpu")
            make_dp_train_step(model, cfg, mesh)(
                state, shard_batch(batch, mesh), 1)
        else:
            make_train_step(model, cfg)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
        states.append(_state(model))
    out = {f"{tag}/{k}": v for tag, s in zip(("group", "plain"), states)
           for k, v in s.items()}
    mesh = Mesh(place_shards(4, "cpu"), ("z",))
    fn = make_sharded_infer_fn(AnalyticNet(), infer_cfg(), mesh,
                               normalize=False)
    out["labels"] = unshard(fn(shard_volume(inp["volume"], mesh)), mesh)
    assert_reference_blocked()
    np.savez(os.path.join(tmp, "world1_rank0.npz"), **out)


WORKERS = {"dp": _worker_dp, "world1": _worker_world1}


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Initial weights (the small net's from random flax variables, as the
    JAX side starts from them), batches and BatchNorm inputs, written for
    the workers."""
    from tpuseg.core import ModelConfig
    from tpuseg.data import synthesize_volume as ref_synthesize_volume
    from tpuseg.data.normalize import percentile_normalize
    from tpuseg_torch.ckpt import port_state_from_jax
    from tpuseg_torch.data import PatchSampler, synthesize_volume
    from tpuseg_torch.models import build_model

    from test_torch_model import _randomized_variables

    tmp = tmp_path_factory.mktemp("dp")
    variables = _randomized_variables(ModelConfig(**SMALL), seed=3)
    torch.save(port_state_from_jax(variables), tmp / "small.pt")
    torch.save(build_model(fused_cfg().model, seed=4).state_dict(),
               tmp / "fused.pt")
    vol = synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=0)
    s = PatchSampler([vol], patch_size=(16, 16, 16), batch_size=8,
                     max_instances=8, seed=0)
    arrays = {f"b{i}_{k}": v for i in range(3)
              for k, v in s.next_batch().items()}
    fvol = synthesize_volume(shape=(16, 32, 64), num_instances=4, seed=1)
    fs = PatchSampler([fvol], patch_size=(8, 16, 64), batch_size=4,
                      max_instances=8, seed=0)
    arrays.update({f"f_{k}": v for k, v in fs.next_batch().items()})
    rng = np.random.default_rng(7)
    arrays.update(
        bn_x=(rng.normal(size=(4, 3, 4, 5, 6)) * 2 + 1).astype(np.float32),
        bn_g=rng.normal(size=(4, 3, 4, 5, 6)).astype(np.float32),
        bn_w=rng.normal(size=3).astype(np.float32),
        bn_b=rng.normal(size=3).astype(np.float32))
    arrays["volume"] = np.asarray(percentile_normalize(ref_synthesize_volume(
        shape=(64, 32, 32), num_instances=8, radius_range=(3.0, 5.0),
        noise=0.0, seed=4).image))
    np.savez(tmp / "inputs.npz", **arrays)
    return tmp, arrays, variables


@pytest.fixture(scope="module")
def dp_ranks(case):
    return run_workers(__file__, "dp", case[0])


def _batch(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _single_step(cfg, state_path, batches):
    """The single-process port: metrics of each step and the final
    state."""
    from tpuseg_torch.train import create_train_state, make_train_step

    model = _model(cfg, state_path)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    metrics = [{k: float(v) for k, v in step(
        state, {k: torch.from_numpy(v) for k, v in b.items()}, 1).items()}
        for b in batches]
    return metrics, _state(model)


def _rank_state(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def test_dp_step_matches_single_process(dp_ranks, case):
    """Augmentation on: each rank numbers its examples from rank x 4, so a
    2-process step draws the single-process step's augmentations."""
    tmp, arrays, _ = case
    metrics, want = _single_step(small_cfg(True), tmp / "small.pt",
                                 [_batch(arrays, "b0_")])
    for res in dp_ranks:
        np.testing.assert_allclose(float(res["aug1_step0_loss"]),
                                   metrics[0]["loss"], rtol=1e-5)
        got = _rank_state(res, "aug1_step0/")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)


def test_dp_steps_keep_ranks_bitwise_equal(dp_ranks):
    """Three augmented steps: parameters and running statistics stay
    bitwise equal on both ranks, and the metrics too."""
    for i in range(3):
        a, b = (_rank_state(r, f"aug1_step{i}/") for r in dp_ranks)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(i, k))
        assert dp_ranks[0][f"aug1_step{i}_loss"] == \
            dp_ranks[1][f"aug1_step{i}_loss"]


def test_dp_step_matches_jax_dp_step(dp_ranks, case):
    """Augmentation off: the port's 2-process step against the JAX
    package's ``make_dp_train_step`` on a 2-device mesh, both from the same
    weights (``port_state_from_jax``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpuseg.core import Config, DataConfig, ModelConfig, TrainConfig
    from tpuseg.models import build_model as ref_build_model
    from tpuseg.train.dp import make_dp_train_step as ref_dp_step
    from tpuseg.train.dp import shard_batch as ref_shard_batch
    from tpuseg.train.step import TrainState as RefTrainState
    from tpuseg.train.step import make_optimizer as ref_make_optimizer
    from tpuseg_torch.ckpt import jax_variables_from_port

    from test_torch_train_step import _compare

    _, arrays, variables = case
    cfg = Config(model=ModelConfig(**SMALL),
                 data=DataConfig(patch_size=(16, 16, 16), batch_size=8,
                                 max_instances=8, augment=False),
                 train=TrainConfig(lr=LR, warmup_steps=1, total_steps=4))
    model = ref_build_model(cfg.model)
    tx = ref_make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = RefTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray,
                                                   variables["batch_stats"]),
                          opt_state=tx.init(params), tx=tx)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    state, m = ref_dp_step(model, cfg, mesh)(
        state, ref_shard_batch(_batch(arrays, "b0_"), mesh),
        jax.random.key(1))
    ref_metrics = [{k: float(v) for k, v in m.items()}]
    for res in dp_ranks:
        got = {k: torch.from_numpy(v) for k, v in
               _rank_state(res, "aug0_step0/").items()}
        metrics = [{k: float(res[f"aug0_step0_{k}"]) for k in ref_metrics[0]}]
        _compare((metrics, jax_variables_from_port(got)),
                 (ref_metrics, {"params": state.params,
                                "batch_stats": state.batch_stats}, variables),
                 lr=LR)


def test_dp_fused_apply_matches_single_process(dp_ranks, case):
    """``train.apply_impl="fused"`` under DP (K6's twin here, batch 4 split
    2 + 2): the BatchNorms the fused apply reuses share their statistics,
    so the step meets the reference's population bound against the
    single-process fused step: more than 99.9% of the parameters' elements
    close, none more than 2.5 lr off. The fraction is over all parameters
    together: Adam's first update is ``g / (|g| + 1e-8)`` of lr, so an
    element whose gradient cancels to ~1e-8 (one of enc0.conv0's 864 here)
    moves by a fraction of lr that the sums' order decides."""
    tmp, arrays, _ = case
    metrics, want = _single_step(fused_cfg(), tmp / "fused.pt",
                                 [_batch(arrays, "f_")])
    keys = [k for k in want if k.endswith(("weight", "bias"))]
    for res in dp_ranks:
        np.testing.assert_allclose(float(res["fused_loss"]),
                                   metrics[0]["loss"], rtol=1e-5)
        got = _rank_state(res, "fused/")
        close = np.concatenate([np.isclose(got[k], want[k], rtol=1e-3,
                                           atol=1e-5).reshape(-1)
                                for k in keys])
        assert close.mean() > 0.999, close.mean()
        for k in keys:
            assert np.abs(got[k] - want[k]).max() < 2.5 * LR, k


def test_synced_batch_norm_gradients_equal_global_batch(dp_ranks, case):
    """The synced ``train_batch_norm`` on each rank's half: outputs, input
    gradients and running statistics of the BN of the whole batch, and its
    weight and bias gradients summed over the ranks. (A bare all_reduce of
    the statistics, without a backward, gives other input gradients.)"""
    from tpuseg_torch.models.blocks import train_batch_norm

    _, arrays, _ = case
    x = torch.from_numpy(arrays["bn_x"]).requires_grad_()
    w = torch.from_numpy(arrays["bn_w"]).requires_grad_()
    b = torch.from_numpy(arrays["bn_b"]).requires_grad_()
    rm, rv = torch.zeros(3), torch.ones(3)
    y = train_batch_norm(x, w, b, rm, rv)
    (y * torch.from_numpy(arrays["bn_g"])).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r["bn_y"] for r in dp_ranks]), y.detach().numpy(),
        **tol)
    np.testing.assert_allclose(
        np.concatenate([r["bn_dx"] for r in dp_ranks]), x.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r["bn_dw"] for r in dp_ranks),
                               w.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r["bn_db"] for r in dp_ranks),
                               b.grad.numpy(), **tol)
    for r in dp_ranks:
        np.testing.assert_allclose(r["bn_rm"], rm.numpy(), **tol)
        np.testing.assert_allclose(r["bn_rv"], rv.numpy(), **tol)


def test_group_of_one_equals_no_group(case):
    """One process on a group of one: the DP step equals the plain step
    bitwise, and sharded labels through the collectives equal the labels
    without a group."""
    from chip_smoke import AnalyticNet
    from tpuseg_torch.infer import make_sharded_infer_fn, shard_volume, unshard
    from tpuseg_torch.parallel import Mesh

    from test_torch_multihost import port_cfg as infer_cfg

    tmp, arrays, _ = case
    (res,) = run_workers(__file__, "world1", tmp, n=1, backend="gloo")
    group, plain = (_rank_state(res, p) for p in ("group/", "plain/"))
    assert group.keys() == plain.keys()
    for k in group:
        np.testing.assert_array_equal(group[k], plain[k], err_msg=k)
    mesh = Mesh(["cpu"] * 4, ("z",))
    fn = make_sharded_infer_fn(AnalyticNet(), infer_cfg(), mesh,
                               normalize=False)
    want = unshard(fn(shard_volume(arrays["volume"], mesh)), mesh)
    assert want.max() >= 6
    np.testing.assert_array_equal(res["labels"], want)


def test_cli_train_in_two_processes(tmp_path):
    """``python -m tpuseg_torch.cli.train`` as two processes, batch 2 split
    1 + 1: rank 0 alone writes the checkpoints and the log; ``--resume``
    restores both ranks from the step it wrote and continues."""
    ck = tmp_path / "ck"
    log = tmp_path / "log.jsonl"
    args = ["-m", "tpuseg_torch.cli.train", "--device", "cpu",
            "--synthetic", "1", "--log", str(log),
            "--set", "model.features=[4,8]", "--set", "model.head_features=4",
            "--set", "data.patch_size=[8,16,16]",
            "--set", "data.batch_size=2", "--set", "train.log_every=1",
            "--set", "train.ckpt_dir=" + json.dumps(str(ck))]
    outs = run_processes(args + ["--set", "train.total_steps=2"])
    for r, out in enumerate(outs):
        assert f"process {r}/2 on cpu, backend gloo" in out
        assert ("done: step 2" in out) == (r == 0)
    assert sorted(os.listdir(ck)) == ["2", "config.json"]
    run_processes(args + ["--resume", "--set", "train.total_steps=3"])
    steps = [json.loads(line)["step"] for line in log.read_text().splitlines()]
    assert steps == [1, 2, 3]
    assert sorted(os.listdir(ck)) == ["2", "3", "config.json"]


if __name__ == "__main__":
    block_reference()
    torch.set_num_threads(2)
    WORKERS[sys.argv[1]](sys.argv[2])
