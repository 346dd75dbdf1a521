"""The train step as a captured program (``tpuseg_torch/train/step.py``'s
``TrainStep`` over ``infer/graph.CapturedProgram``), on the CPU.

A CUDA graph cannot be captured here. The wrapper's part runs against
``TrainStandIn``, a graph backend that does what a CUDA capture does to a
training body's state: its capture leaves the parameters, BatchNorm
statistics, optimizer moments and generators as it found them (a capture
runs nothing), and each replay runs the body once on the static arguments,
from the generators' state at the replay, writing the graph's outputs and
putting the host counters back (a replay runs no Python). Through it, the
program's steps equal the eager body's steps exactly, so every comparison
here is bitwise (no tolerance), the AdamW one against the update with
host-float learning rate and bias corrections too. The real capture runs
on the card (``chip_smoke.py`` phase 21). The step's parity with the JAX
package stays in ``test_torch_train_step.py``."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpuseg_torch.train.loop as loop
from tpuseg_torch.core import Config, DataConfig, ModelConfig, TrainConfig
from tpuseg_torch.data import PatchSampler, synthesize_volume
from tpuseg_torch.infer.graph import CudaGraphs, _counters, _tensors
from tpuseg_torch.models import build_model
from tpuseg_torch.train import (AdamW, create_train_state, make_train_step,
                                train)
from tpuseg_torch.train.step import (GeneratorBank, _AUGMENT, _ZSCALE,
                                     example_generator)

from test_torch_model import single_torch_thread  # noqa: F401


class _Graph:
    def __init__(self, fn, args, out, generators):
        self.fn, self.args, self.out = fn, args, out
        self.generators, self.replays = list(generators), 0


def _training_tensors(step):
    """What a training body changes besides its outputs."""
    m = step.model
    return [*m.parameters(), *m.buffers(), *step.state.opt.moments()]


class TrainStandIn:
    """A graph backend for ``TrainStep.body`` that takes CPU tensors
    (module docstring)."""

    released = []

    @staticmethod
    def accepts(devices):
        return len(devices) == 1

    @staticmethod
    def new_pool():
        return object()

    @staticmethod
    def capture(fn, args, pool, device, generators=()):
        tensors = _training_tensors(fn.__self__)
        saved = [t.detach().clone() for t in tensors]
        rng = [g.get_state() for g in generators]
        out = fn(*args)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        for g, s in zip(generators, rng):
            g.set_state(s)
        return _Graph(fn, args, out, generators), out, 0

    @staticmethod
    def replay(graph, device):
        counters = [(o, a, getattr(o, a)) for o, a in _counters()]
        fresh = graph.fn(*graph.args)
        for o, a, n in counters:
            setattr(o, a, n)
        for dst, src in zip(_tensors(graph.out), _tensors(fresh)):
            dst.copy_(src)
        graph.replays += 1

    @staticmethod
    def release(graphs):
        TrainStandIn.released.extend(graphs)


@pytest.fixture
def standin(monkeypatch):
    """Every program on the stand-in backend, which takes the CPU as the
    card; its releases recorded."""
    for name in ("accepts", "new_pool", "capture", "replay", "release"):
        monkeypatch.setattr(CudaGraphs, name, getattr(TrainStandIn, name))
    monkeypatch.setattr(TrainStandIn, "released", [])
    return TrainStandIn


def _cfg(apply_impl="flax", batch=2, zscale=(0.5, 1.0), **train_kw):
    """Narrow U-Net, batch of 16^3, augmentation (and z-scale) on, and a
    warmup longer than the steps run, so lr changes every step."""
    return Config(
        model=ModelConfig(features=(32, 64), head_features=32,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(16, 16, 16), batch_size=batch,
                        max_instances=8, aug_zscale=zscale),
        train=TrainConfig(total_steps=20, warmup_steps=10, lr=1e-3,
                          apply_impl=apply_impl, **train_kw))


def _batches(n, batch=2):
    vol = synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=5)
    s = PatchSampler([vol], patch_size=(16, 16, 16), batch_size=batch,
                     max_instances=8, seed=1)
    return [{k: torch.from_numpy(v) for k, v in s.next_batch().items()}
            for _ in range(n)]


def _model(cfg):
    return build_model(cfg.model, seed=7)


def _snapshot(state):
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "mu": {k: v.clone() for k, v in state.opt.mu.items()},
            "nu": {k: v.clone() for k, v in state.opt.nu.items()}}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _host_float_update(opt, params, grads, grad_norm):
    """``AdamW.update`` as it ran before the step was captured: host-float
    lr and bias corrections, moments rebound to new tensors."""
    keep = grad_norm < opt.max_norm
    lr = opt.schedule(opt.count)
    opt.count += 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(opt.b1) ** f32(opt.count))
    bc2 = float(f32(1) - f32(opt.b2) ** f32(opt.count))
    for k, p in params.items():
        g = torch.where(keep, grads[k], grads[k] / grad_norm * opt.max_norm)
        mu = (1 - opt.b1) * g + opt.b1 * opt.mu[k]
        nu = (1 - opt.b2) * (g * g) + opt.b2 * opt.nu[k]
        opt.mu[k], opt.nu[k] = mu, nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
        u = u + opt.weight_decay * p
        p.add_(u * -lr)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_in_place_adamw_equals_the_host_float_update(scale):
    """Six updates with lr rising through the warmup, unclipped (global
    norm < 1) and clipped: the in-place update, its lr and bias
    corrections read from the ``hyper`` tensor, == the host-float update
    bitwise; the moments keep their storage; ``apply`` leaves ``count``
    alone."""
    rng = np.random.default_rng(3)
    shapes = {"a.weight": (6, 5), "a.bias": (6,), "b.weight": (7, 3, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tc = TrainConfig(lr=1e-2, warmup_steps=4, total_steps=9, weight_decay=0.1)
    new = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    old = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt_new, opt_old = AdamW(new, tc), AdamW(old, tc)
    ptrs = [t.data_ptr() for t in opt_new.moments()]
    for _ in range(6):
        g = {k: torch.from_numpy((rng.normal(size=s) * scale).astype(
            np.float32)) for k, s in shapes.items()}
        norm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
        hyper = opt_new.hyper(norm.device)
        opt_new.apply(new, g, norm, hyper)
        assert opt_new.count == opt_old.count
        opt_new.count += 1
        _host_float_update(opt_old, old, g, norm)
        _assert_same(new, old)
        _assert_same(opt_new.mu, opt_old.mu)
        _assert_same(opt_new.nu, opt_old.nu)
    assert [t.data_ptr() for t in opt_new.moments()] == ptrs
    assert opt_new.count == 6


@pytest.mark.parametrize("streams", [(_AUGMENT,), (_ZSCALE, _AUGMENT)])
def test_bank_draws_what_fresh_generators_draw(streams):
    """A bank reseeded for (seed, step, offset) draws exactly what fresh
    generators of ``example_generator`` draw, step after step, from the
    same generator objects."""
    bank = GeneratorBank(streams, "cpu")
    kept = None
    for step, offset, n in ((0, 0, 3), (1, 4, 3), (7, 2, 2)):
        gens = bank.reseed(11, step, offset, n)
        assert tuple(gens) == streams
        ids = [[id(g) for g in gens[s]] for s in streams]
        if kept is not None:
            assert all(a[:n] == b[:n] for a, b in zip(ids, kept))
        kept = ids
        for s in streams:
            for i, g in enumerate(gens[s]):
                fresh = example_generator(11, step, offset + i, s, "cpu")
                draws = [(torch.rand(6, generator=x),
                          torch.randn((4, 5, 6), generator=x))
                         for x in (g, fresh)]
                for got, want in zip(*draws):
                    _assert_same(got, want)


def test_body_ignores_host_counters():
    """With the body's arguments and the generators' states fixed, poking
    ``state.step`` and ``opt.count`` to other values changes nothing the
    body computes: what changes from step to step reaches it only as
    arguments (``hyper``) and through the generators."""
    cfg = _cfg()
    batch = _batches(1)[0]
    state = create_train_state(_model(cfg), cfg)
    step = make_train_step(state.model, cfg)
    step.eager(state, batch, 1)                    # a step in, moments set
    args = step.prepare(state, batch, 1)
    start = _snapshot(state)
    rng = {s: [g.get_state() for g in gens]
           for s, gens in step.generators.items()}
    runs = []
    for poked_step, poked_count in ((state.step, state.opt.count),
                                    (1234, 77)):
        with torch.no_grad():
            state.model.load_state_dict(start["model"])
            for k in start["mu"]:
                state.opt.mu[k].copy_(start["mu"][k])
                state.opt.nu[k].copy_(start["nu"][k])
        for s, gens in step.generators.items():
            for g, r in zip(gens, rng[s]):
                g.set_state(r)
        state.step, state.opt.count = poked_step, poked_count
        metrics = step.body(*args)
        runs.append((metrics, _snapshot(state)))
    _assert_same(runs[0][0], runs[1][0])
    _assert_same(runs[0][1], runs[1][1])
    # the poked counters would have changed both the draws and the lr
    other = step.prepare(state, batch, 1)[1]
    assert not torch.equal(other, args[1])


@pytest.mark.parametrize("apply_impl,grad_accum", [
    ("flax", 1), ("fused", 1), ("flax", 2), ("fused", 2)])
def test_program_steps_equal_eager_steps(standin, apply_impl, grad_accum):
    """Five steps through the program (eager, capture, three replays) ==
    five eager steps of a twin model from the same seed, bitwise after
    every step: metrics, parameters, BatchNorm statistics, moments. The
    capture call advances the state once; the generators registered at
    the capture are the bank's."""
    cfg = _cfg(apply_impl, batch=4)
    batches = _batches(5, batch=4)
    ref = create_train_state(_model(cfg), cfg)
    got = create_train_state(_model(cfg), cfg)
    eager = make_train_step(ref.model, cfg, grad_accum=grad_accum)
    prog = make_train_step(got.model, cfg, grad_accum=grad_accum)
    assert prog.program.mode == "captured"
    runs = []
    for i, b in enumerate(batches):
        want = eager.eager(ref, b, 1)
        out = prog(got, b, 1)
        runs.append(prog.program.last_run)
        assert got.step == ref.step == i + 1
        assert got.opt.count == ref.opt.count == i + 1
        _assert_same(out, want)
        _assert_same(_snapshot(got), _snapshot(ref))
    assert runs == ["eager: first sight", "capture", "replay", "replay",
                    "replay"]
    (graph,) = prog.program.graphs.values()
    assert prog.program.captures == 1 and graph.graph.replays == 4
    bank = prog.banks[torch.device("cpu")]
    assert graph.graph.generators == [
        g for gens in bank.generators.values() for g in gens]
    assert len(graph.graph.generators) == 2 * 4
    assert not standin.released


def test_grouped_step_runs_eagerly(standin):
    """Under a process group (here gloo, one rank) the step runs eagerly on
    every call, by the stated rule, and equals the ungrouped step."""
    cfg = _cfg()
    batches = _batches(3)
    ref = create_train_state(_model(cfg), cfg)
    got = create_train_state(_model(cfg), cfg)
    eager = make_train_step(ref.model, cfg)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grouped = make_train_step(got.model, cfg,
                                  axis_name=dist.group.WORLD)
        assert grouped.program.mode == "eager: torch.distributed group"
        for b in batches:
            want = eager.eager(ref, b, 1)
            _assert_same(grouped(got, b, 1), want)
            assert grouped.program.last_run == grouped.program.mode
    finally:
        dist.destroy_process_group()
    assert not grouped.program.graphs
    _assert_same(_snapshot(got), _snapshot(ref))


def _loop_config(ckpt_dir, steps=6, **kw):
    kw = {"warmup_steps": 10, "log_every": 2, "ckpt_every": 2, "lr": 1e-3,
          "val_fraction": 0.5, "val_every": 2, "val_patches": 2,
          "val_f1": True, **kw}
    return Config(
        model=ModelConfig(features=(4, 8), head_features=4,
                          compute_dtype="float32"),
        data=DataConfig(patch_size=(16, 16, 16), batch_size=2,
                        max_instances=8),
        train=TrainConfig(total_steps=steps, ckpt_dir=str(ckpt_dir), **kw))


@pytest.fixture
def made(monkeypatch):
    """The train steps ``train()`` makes."""
    steps = []
    orig = loop.make_train_step

    def record(*a, **kw):
        steps.append(orig(*a, **kw))
        return steps[-1]

    monkeypatch.setattr(loop, "make_train_step", record)
    return steps


def test_loop_captures_once_through_validation_checkpoints_and_resume(
        standin, made, tmp_path):
    """``train()`` with a validation (eval mode, the val-volume inference)
    and a checkpoint every two steps captures once and releases nothing;
    its result == the eager loop's. A run stopped at step 3 and resumed to
    6 also captures once a run and == the uninterrupted run; resume copies
    the moments into the optimizer's own tensors."""
    vols = [synthesize_volume(shape=(32, 32, 32), num_instances=4, seed=s)
            for s in (0, 9)]
    whole, hist = train(_loop_config(tmp_path / "a"), vols, device="cpu")
    (step,) = made
    assert [step.program.captures, len(step.program.graphs)] == [1, 1]
    assert step.program.last_run == "replay" and not standin.released
    assert sum("val_loss" in h for h in hist) == 3
    with pytest.MonkeyPatch.context() as mp:      # the eager loop
        mp.setattr(CudaGraphs, "accepts", staticmethod(lambda d: False))
        plain, plain_hist = train(_loop_config(tmp_path / "p"), vols,
                                  device="cpu")
    assert made[1].program.last_run == "eager: not on one CUDA device"
    _assert_same(_snapshot(whole), _snapshot(plain))
    untimed = [[{k: v for k, v in h.items() if k != "mvox_per_s"}
                for h in run] for run in (hist, plain_hist)]
    assert untimed[0] == untimed[1]
    train(_loop_config(tmp_path / "b", steps=3), vols, device="cpu")
    resumed, _ = train(_loop_config(tmp_path / "b"), vols, resume=True,
                       device="cpu")
    assert resumed.step == 6 and resumed.opt.count == 6
    for s in made[2:]:
        assert s.program.captures == 1 and s.program.last_run == "replay"
    assert not standin.released
    _assert_same(_snapshot(resumed), _snapshot(whole))


def test_moved_moments_release_the_graph(standin):
    """The program's context covers the optimizer's moments: one rebound
    to new storage releases the graph, and the next step is eager again."""
    cfg = _cfg(zscale=None)
    batches = _batches(4)
    state = create_train_state(_model(cfg), cfg)
    step = make_train_step(state.model, cfg)
    for b in batches[:3]:
        step(state, b, 1)
    assert step.program.last_run == "replay"
    k = next(iter(state.opt.mu))
    state.opt.mu[k] = state.opt.mu[k].clone()
    step(state, batches[3], 1)
    assert step.program.last_run == "eager: first sight"
    assert len(standin.released) == 1


def test_eval_mode_between_steps_releases_nothing(standin):
    """A model left in eval mode between steps (a validation that does not
    put it back) is put in train mode before the program reads its
    context: the graph is kept and the steps equal uninterrupted ones."""
    cfg = _cfg(zscale=None)
    batches = _batches(4)
    ref = create_train_state(_model(cfg), cfg)
    got = create_train_state(_model(cfg), cfg)
    eager = make_train_step(ref.model, cfg)
    step = make_train_step(got.model, cfg)
    ref.model.train()
    for b in batches:
        got.model.eval()
        _assert_same(step(got, b, 1), eager.eager(ref, b, 1))
        assert got.model.training
    assert step.program.last_run == "replay" and not standin.released
    _assert_same(_snapshot(got), _snapshot(ref))
