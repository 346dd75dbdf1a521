"""The output checks catch what they exist for: a sound run of each cell
comes out ``correct`` at a tiny size on the CPU, and a run with the timed
path broken underneath comes out not ``correct``, once for each fault the
cell can have. (A single-card cell has no exchange between cards to leave
out; an inference call keeps no state from call to call.)"""

import time

import pytest
import torch

from perfbench import infer_cell, train_cell
from perfbench.tests.tiny import tiny_cell

CELLS = ["infer-stack600", "infer-touch400", "train-b8-p64"]


def _run(name, seed=5):
    cell = tiny_cell(name)
    driver = infer_cell if cell.config["kind"] == "infer" else train_cell
    return driver.run(cell, seed, 0.2, False, time.perf_counter(),
                      device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0


def _alter_one_label(monkeypatch):
    from tpuseg_torch.infer import pipeline

    real = pipeline.size_filter_and_compact

    def altered(labels, min_size, plain=False):
        out = real(labels, min_size, plain=plain).clone()
        out.view(-1)[out.numel() // 2] += 1
        return out

    monkeypatch.setattr(pipeline, "size_filter_and_compact", altered)


def _sweep_half_the_tiles(monkeypatch):
    from tpuseg_torch.infer import tiles

    real = tiles.tile_grid
    monkeypatch.setattr(tiles, "tile_grid",
                        lambda shape, tile: real(shape, tile)[::2])


def _update_nothing(monkeypatch):
    from tpuseg_torch.train import step

    monkeypatch.setattr(step.AdamW, "apply", lambda *a, **k: None)


def _half_the_batch(monkeypatch):
    from tpuseg_torch.train import step

    real = step.loss_fn

    def half(model, batch, cfg, seed, n_step, example_offset=0,
             apply_fn=None, generators=None):
        n = batch["image"].shape[0] // 2
        batch = {k: v[:n] for k, v in batch.items()}
        if generators is not None:
            generators = {s: g[:n] for s, g in generators.items()}
        return real(model, batch, cfg, seed, n_step, example_offset,
                    apply_fn, generators)

    monkeypatch.setattr(step, "loss_fn", half)


FAULTS = [("infer-stack600", _alter_one_label),
          ("infer-stack600", _sweep_half_the_tiles),
          ("infer-touch400", _alter_one_label),
          ("infer-touch400", _sweep_half_the_tiles),
          ("train-b8-p64", _update_nothing),
          ("train-b8-p64", _half_the_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_fault_makes_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name)
    assert not res.correct, res.checks


def test_fp8_control_rounds_coarser_than_bf16():
    from perfbench.reference.quant import fp8

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g)
    rel8 = ((fp8(x) - x).abs() / x.abs().clamp(min=1e-3)).median()
    rel16 = ((x.bfloat16().float() - x).abs()
             / x.abs().clamp(min=1e-3)).median()
    assert rel8 > 8 * rel16
    w = x.clone().requires_grad_(True)
    fp8(w).sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
