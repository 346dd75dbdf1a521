"""A training cell: a closed loop of optimizer steps, fed by the program's
own prefetcher.

Set-up makes the traffic's volumes from the seed (the mix's generator, on
the card, then on the host for the sampler), draws the initial weights on
the card from the seed (the architecture's ``init_state``,
``arch/<name>.py``) into its model (``build``), and wires the program as
``train/loop.train`` does: ``make_train_step(model, cfg)`` fed by
``BatchPrefetcher(PatchSampler, upload)``, the upload pinning and copying
without blocking. The first three steps run through that same step and
feed (eager, capture, replay) and are the ones the check follows; the
window then runs the same objects on, reading the metrics every
``train.log_every`` steps as the loop does, and ends at the first such
read after ``--seconds``.

Check: the reference trainer (``reference/train.py``) starts from the same
initial state dict on the same raw patches (recorded as the sampler handed
them to the prefetcher) and follows the first three steps in float32. The
compared numbers: each step's loss; the first gradient as the optimizer
took it (the program's from its first moment after step 1), by the worst
leaf of its norm; and the change of the parameters and of the statistics
(the state the architecture's ``is_statistic`` names) after step 3, by the
worst leaf of its norm. A leaf's gap is ``|norm(program) -
norm(reference)|`` over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the gradient and parameter numbers.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import cells, gen, tracing
from perfbench.reference import exact_float32
from perfbench.reference.train import B1, Trainer

CHECKED = 3


class Recorder:
    """A sampler that keeps copies of the first ``keep`` batches it hands
    out; every other attribute is the sampler's."""

    def __init__(self, sampler, keep: int):
        self._sampler, self._keep, self.batches = sampler, keep, []

    def next_batch(self):
        batch = self._sampler.next_batch()
        if len(self.batches) < self._keep:
            self.batches.append({k: v.copy() for k, v in batch.items()})
        return batch

    def __getattr__(self, name):
        return getattr(self._sampler, name)


def uploader(device):
    """``train/loop``'s host-to-device upload."""
    if torch.device(device).type == "cpu":
        return lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    return lambda b: {k: torch.from_numpy(v).pin_memory().to(
        device, non_blocking=True) for k, v in b.items()}


def settle(feed, timeout: float = 2.0, after: float = 0.05) -> None:
    """Wait until the prefetcher has filled its queue, and ``after`` more
    for the batch its worker then makes: an upload that lands during the
    eager step or the capture sets the memory peak by where its block
    falls."""
    end = time.perf_counter() + timeout
    while not feed._q.full() and time.perf_counter() < end:
        time.sleep(0.005)
    time.sleep(after)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> cells.Result:
    from tpuseg_torch.data.prefetch import BatchPrefetcher
    from tpuseg_torch.data.sampler import PatchSampler
    from tpuseg_torch.train.step import create_train_state, make_train_step

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    arch = cells.load_arch(cells.arch_name(cell.config))
    vols = [gen.Volume(v.image.cpu().numpy(), v.centers, v.half_sizes)
            for v in gen.volumes_for(cell.traffic["volumes"], seed, device)]
    cells.phase("traffic")
    state0 = arch.init_state(cell.config["model"], gen.sub_seed(seed, 3),
                             device)
    cells.reset_peak(device)
    cells.phase("weights")
    cfg = cells.program_config(cell.config)
    model = arch.build(cfg, cell.config["model"], device)
    model.load_state_dict(state0)
    model.train()
    tstate = create_train_state(model, cfg)
    step = make_train_step(model, cfg, grad_accum=cfg.train.grad_accum)
    sampler = Recorder(PatchSampler(vols, patch_size=cfg.data.patch_size,
                                    batch_size=cfg.data.batch_size,
                                    max_instances=cfg.data.max_instances,
                                    seed=gen.sub_seed(seed, 5)), CHECKED)
    feed = BatchPrefetcher(sampler, uploader(device),
                           depth=cfg.train.prefetch_depth)
    step_seed = gen.sub_seed(seed, 6)
    every = cfg.train.log_every
    cells.phase("program")
    try:
        losses = []
        for n, name in enumerate(("eager", "capture", "replay")):
            batch = feed.next()
            settle(feed)
            cells.phase(f"feed{n}")
            metrics = step(tstate, batch, step_seed)
            losses.append(float(metrics["loss"]))
            cells.phase(name)
            if n == 0:
                grad1 = {k: v / (1 - B1) for k, v in tstate.opt.mu.items()}
        after = {k: v.detach().clone()
                 for k, v in model.state_dict().items()}
        sync()
        setup_s = time.perf_counter() - t_start

        waits, enq = [], []
        limit = cell.spec["trace_units"] if trace else None
        trace_path = str(cells.CACHE / "trace" / f"{cell.name}.json")
        with (tracing.traced(trace_path) if trace
              else contextlib.nullcontext()):
            with tracing.span(tracing.WINDOW):
                t0 = time.perf_counter()
                i = 0
                while True:
                    a = time.perf_counter()
                    with tracing.span("step.feed_wait"):
                        batch = feed.next()
                    b = time.perf_counter()
                    with tracing.span("step.enqueue"):
                        metrics = step(tstate, batch, step_seed)
                    c = time.perf_counter()
                    waits.append(b - a)
                    enq.append(c - b)
                    i += 1
                    if i % every == 0 or (limit is not None and i >= limit):
                        with tracing.span("step.log_read"):
                            float(metrics["loss"])
                        t = time.perf_counter()
                        if (t - t0 >= seconds if limit is None
                                else i >= limit):
                            break
                window = t - t0
    finally:
        feed.close()
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    vox = cfg.data.batch_size * int(np.prod(cfg.data.patch_size))
    metrics = {"train_mvox_s": {"value": vox * i / window / 1e6,
                                "unit": "Mvox/s"},
               "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    breakdown = None
    device_info = cells.device_record(cell, device, peak)
    if trace:
        tr = tracing.Trace(trace_path)
        breakdown = tr.breakdown()
        m = cell.config["model"]
        r = cells.Run(units=i, window_s=window,
                      spans={"feed_wait": waits, "enqueue": enq},
                      counters={}, trace=tr,
                      work={**arch.work(m, "train", batch=cfg.data.batch_size,
                                        patch=cfg.data.patch_size),
                            "model_flops": 3 * vox * arch.flops_per_voxel(m)})
        metrics = cells.read_metrics(cell, r)
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    metrics = {k: v for k, v in metrics.items() if k in names}

    program = {"losses": losses, "grad1": grad1, "after": after}
    del step, tstate, model, feed
    if cuda:
        torch.cuda.empty_cache()
    got = readings(cell, state0, sampler.batches, step_seed, program, device)
    limits = cell.spec["check"]["limits"]
    checks = [(k, got[k], limits[k]) for k in limits]
    correct = all(v <= lim for _, v, lim in checks)
    return cells.Result(correct, i, 0, metrics, device_info, checks,
                        breakdown)


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in d.items()}


def _worst(got: dict, want: dict, keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def reference_run(cell, state0, batches, step_seed, device, quant=None):
    """The reference's three steps from ``state0``: losses, the first
    gradient and the state after."""
    exact_float32()
    trainer = Trainer(cells.load_arch(cells.arch_name(cell.config)), state0,
                      cells.sections(cell.config), device, quant)
    losses, grad1 = [], None
    for n, raw in enumerate(batches):
        out = trainer.step(raw, step_seed)
        losses.append(out["loss"])
        if n == 0:
            grad1 = out["grads"]
    after = {**{k: v.detach() for k, v in trainer.params.items()},
             **trainer.stats}
    return {"losses": losses, "grad1": grad1, "after": after}


def compare(state0: dict, got: dict, want: dict) -> dict:
    """The compared numbers of a run ``got`` against the reference's
    ``want`` (each from :func:`reference_run`'s fields)."""
    g_want = _norms(want["grad1"])
    med = float(np.median(list(g_want.values())))
    moving = [k for k, v in g_want.items() if v >= 1e-3 * med]
    params = list(want["grad1"])
    stats = [k for k in state0 if k not in want["grad1"]]

    def change(after, keys):
        return _norms({k: after[k].float() - state0[k].float() for k in keys})

    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], want["losses"])),
        "grad_gap": _worst(_norms(got["grad1"]), g_want, moving),
        "param_change_gap": _worst(change(got["after"], params),
                                   change(want["after"], params), moving),
        "bn_stats_gap": _worst(change(got["after"], stats),
                               change(want["after"], stats), stats)}


def readings(cell, state0, batches, step_seed, program, device) -> dict:
    want = reference_run(cell, state0, batches, step_seed, device)
    return compare(state0, program, want)
