"""An inference cell: one caller in a closed loop, one stack a call.

Set-up makes the traffic's stacks on the card from the seed (the mix's
generator, ``gen.volumes_for``), loads the configuration's trained weights
(``weights.trained_state``) into its architecture's model
(``arch/<name>.py``: ``build``), calibrates the configuration once from
the first stack's weak annotations (the volume-matched fg threshold's
target fraction, the per-axis NMS radius and the upper normalization
percentile, as ``cli.infer --calibrate-from`` does), builds
``make_infer_fn(model, cfg)`` and calls it three times: eager, capture,
replay. The window then calls it stack after stack, cycling
through the stacks, each call timed from the call to the
``torch.cuda.synchronize()`` that ends it.

The timed call is the configuration's own: ``infer.program="fused"``, the
whole call as one captured graph. The traced run (``--trace 1``) runs the
same stages as two captured graphs on one pool (``"staged"``), so that
CUDA events between them time the sweep and the post-processing apart.

Check: a sample of the window's calls, drawn from the seed, keeps its
labels. Once the window has closed and the program is freed, a twin of the
timed call (``make_infer_stages``' two stages, eager, same model and
configuration) runs each sampled stack again and gives its logits and
labels; its labels must equal the timed call's. The reference works out
each sampled stack's percentile scalars (held to H1 and H2's on the same
stack), its logits over the same tile grid in float32 (the architecture's
plain ``forward``), and the labels of its own post-processing applied to
the twin's probability maps; the twin's maps are held to the reference's,
and the timed call's labels must equal the reference's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import cells, gen, tracing, weights
from perfbench.reference import exact_float32, post, unet


def calibration(config: dict, vol: gen.Volume):
    """``(fg target fraction, NMS radius, upper percentile)`` from the
    weak annotations, by the program's own functions."""
    from tpuseg_torch.ops.calibrate import (adaptive_upper_pct,
                                            expected_fg_fraction,
                                            nms_radius_from_half_sizes)

    frac = expected_fg_fraction(vol.half_sizes, int(np.prod(vol.image.shape)))
    upper = adaptive_upper_pct(frac, default_upper=config["settings"][
        "data.normalize_pcts"][1])
    return frac, nms_radius_from_half_sizes(vol.half_sizes), upper


def build(cell: cells.Cell, seed: int, device, **extra):
    """``(stacks, state, cfg, model, infer)``; ``extra`` settings over the
    configuration's."""
    from tpuseg_torch.infer.pipeline import make_infer_fn

    arch = cells.load_arch(cells.arch_name(cell.config))
    state = weights.trained_state(cell.config, device)
    cells.phase("weights")
    stacks = gen.volumes_for(cell.traffic["volumes"], seed, device)
    cells.reset_peak(device)
    cells.phase("traffic")
    frac, radius, upper = calibration(cell.config, stacks[0])
    pcts = cell.config["settings"]["data.normalize_pcts"]
    cfg = cells.program_config(cell.config, **{
        "postproc.fg_target_fraction": frac,
        "postproc.nms_radius": list(radius),
        "data.normalize_pcts": [pcts[0], upper], **extra})
    model = arch.build(cfg, cell.config["model"], device)
    model.load_state_dict(state)
    model.eval()
    infer = make_infer_fn(model, cfg)
    cells.phase("program")
    return stacks, state, cfg, model, infer


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> cells.Result:
    from tpuseg_torch.ops.resolve import chase_resolve, passes_run

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stacks, state, cfg, model, infer = build(
        cell, seed, device, **({"infer.program": "staged"} if trace else {}))
    for i, name in enumerate(("eager", "capture", "replay")):
        labels = infer(stacks[i % len(stacks)].image)
        sync()
        cells.phase(name)
    # the sample's slots, filled by copies: holding a call's own outputs
    # would make the peak depend on when the sample changes
    slots = [torch.empty_like(labels)
             for _ in range(cell.spec["check"]["samples"])]
    del labels
    sync()
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(gen.sub_seed(seed, 7))
    kept, lat, enq, sweep, post_t, passes = [], [], [], [], [], []
    limit = cell.spec["trace_units"] if trace else None
    trace_path = str(cells.CACHE / "trace" / f"{cell.name}.json")
    ctx = tracing.traced(trace_path) if trace else contextlib.nullcontext()
    events = cuda and trace
    with ctx:
        with tracing.span(tracing.WINDOW):
            t0 = time.perf_counter()
            i = 0
            while True:
                k = i % len(stacks)
                if events:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(3)]
                    ev[0].record()
                a = time.perf_counter()
                with tracing.span("stack.enqueue"):
                    if trace:
                        net, post_stage = infer.programs
                        logits = net(stacks[k].image)
                        if events:
                            ev[1].record()
                        labels = post_stage(logits)
                        del logits
                    else:
                        labels = infer(stacks[k].image)
                b = time.perf_counter()
                if events:
                    ev[2].record()
                with tracing.span("stack.sync"):
                    sync()
                c = time.perf_counter()
                lat.append(c - a)
                enq.append(b - a)
                if events:
                    sweep.append(ev[0].elapsed_time(ev[1]) / 1e3)
                    post_t.append(ev[1].elapsed_time(ev[2]) / 1e3)
                if trace:
                    passes.append(passes_run(chase_resolve.last_gates))
                # reservoir sampling: each call is in the sample alike
                j = (len(kept) if len(kept) < len(slots)
                     else int(rng.integers(0, i + 1)))
                if j < len(slots):
                    slots[j].copy_(labels)
                    kept[j:j + 1] = [k]
                del labels
                i += 1
                if (c - t0 >= seconds if limit is None else i >= limit):
                    break
            window = c - t0
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    voxels = int(np.prod(stacks[0].image.shape))
    metrics = {
        "infer_mvox_s": {"value": voxels * i / window / 1e6,
                         "unit": "Mvox/s"},
        "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"},
        "infer_p95_ms": {"value": float(np.percentile(lat, 95)) * 1e3,
                         "unit": "ms"}}
    breakdown = None
    if trace:
        tr = tracing.Trace(trace_path)
        breakdown = tr.breakdown()
        arch = cells.load_arch(cells.arch_name(cell.config))
        m = cell.config["model"]
        r = cells.Run(units=i, window_s=window,
                      spans={"enqueue": enq, "sweep": sweep, "post": post_t,
                             "unit": lat},
                      counters={"chase_passes": passes}, trace=tr,
                      work={**arch.work(m, "infer",
                                        shape=stacks[0].image.shape,
                                        tile=cfg.infer.tile,
                                        halo=cfg.infer.halo),
                            "model_flops": voxels * arch.flops_per_voxel(m)})
        metrics = cells.read_metrics(cell, r)
    metrics = {k: v for k, v in metrics.items()
               if k in {m["name"] for m in (cell.per_layer if trace
                                            else cell.end_to_end)}}
    device_info = cells.device_record(cell, device, peak)
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)

    sampled = [stacks[k] for k in kept]
    scalars = [program_scalars(cfg, v.image) for v in sampled]
    infer.release()
    del infer
    if cuda:
        torch.cuda.empty_cache()
    inputs, twin_gap = twin_outputs(model, cfg, sampled, slots)
    del model, slots
    checks = check(cell, state, stacks[0], inputs, scalars, twin_gap)
    correct = all(v <= lim for _, v, lim in checks)
    return cells.Result(correct, i, 0, metrics, device_info, checks,
                        breakdown)


def twin_outputs(model, cfg, sampled, labels) -> tuple:
    """``([(stack, logits, timed labels)], twin_label_mismatch)``: the
    twin's logits of each sampled stack beside the timed call's labels, and
    the most voxels by which the twin's labels differ from the timed
    call's."""
    from tpuseg_torch.infer.pipeline import make_infer_stages

    _, stage_net, stage_post = make_infer_stages(model, cfg)
    inputs, gap = [], 0.0
    for vol, timed in zip(sampled, labels):
        logits = stage_net(vol.image)
        gap = max(gap, float((stage_post(logits) != timed).sum()))
        inputs.append((vol, logits, timed))
    return inputs, gap


def program_scalars(cfg, volume) -> tuple:
    """The program's percentile scalars of a stack (H1 and H2 on the card),
    as its sweep computes them: a call of its own on the sampled stack, after
    the window; the timed call keeps its scalars inside the graph, and its
    normalization is held to the reference through the probability gaps."""
    from tpuseg_torch.data.normalize import histogram_percentile_scalars

    lo, hi = histogram_percentile_scalars(
        volume.float(), cfg.data.normalize_pcts,
        sample_stride=cfg.data.normalize_sample_stride)
    return float(lo), float(hi)


def reference_labels(cal: dict, s: dict, fg_prob, peak_prob):
    """The reference's post-processing of a pair of probability maps."""
    thr = post.threshold_for_fraction(fg_prob, cal["fraction"],
                                      s["data"]["normalize_sample_stride"])
    lab = post.watershed(fg_prob, peak_prob, s["postproc"]["peak_threshold"],
                         thr, cal["radius"], s["postproc"]["flood_iters"])
    return post.size_filter_and_compact(lab, s["postproc"]["min_size"])


def readings(cell, state, calibrated_on, inputs, scalars=None,
             quant=None) -> dict:
    """The compared numbers over ``inputs`` (stack, logits, labels): the
    program's (or, with ``quant`` and no logits, the control's) against the
    reference; the configuration calibrated on the stack ``calibrated_on``,
    as the program was."""
    exact_float32()
    s = cells.sections(cell.config)
    arch = cells.load_arch(cells.arch_name(cell.config))
    p32 = {k: v.float() for k, v in state.items()}

    def forward(quant=None):
        return lambda x: arch.forward(p32, x, s["model"], quant=quant)

    out = {"pct_gap": 0.0, "prob_gap_max": 0.0, "prob_gap_mean": 0.0,
           "label_mismatch": 0.0}
    cal = post.calibration(calibrated_on.half_sizes,
                           int(np.prod(calibrated_on.image.shape)),
                           s["data"]["normalize_pcts"][1])
    for n, (vol, logits, labels) in enumerate(inputs):
        pcts = (s["data"]["normalize_pcts"][0], cal["upper"])
        p_lo, p_hi = post.percentile_scalars(
            vol.image, pcts, s["data"]["normalize_sample_stride"])
        if scalars is not None:
            out["pct_gap"] = max(out["pct_gap"],
                                 abs(scalars[n][0] - float(p_lo)),
                                 abs(scalars[n][1] - float(p_hi)))
        ref = unet.tiled_logits(forward(), vol.image, s["infer"]["tile"],
                                s["infer"]["halo"],
                                post.normalizer(p_lo, p_hi))
        if logits is None:         # the control: the reference, rounded
            logits = unet.tiled_logits(forward(quant), vol.image,
                                       s["infer"]["tile"], s["infer"]["halo"],
                                       post.normalizer(p_lo, p_hi))
        maps = {}
        for key in ("fg_logits", "peak_logits"):
            got = torch.sigmoid(logits[key])
            gap = (got.float() - torch.sigmoid(ref[key])).abs()
            out["prob_gap_max"] = max(out["prob_gap_max"], float(gap.max()))
            out["prob_gap_mean"] = max(out["prob_gap_mean"],
                                       float(gap.mean()))
            maps[key] = got
            del gap
        del ref
        if labels is not None:
            lab = reference_labels(cal, s, maps["fg_logits"],
                                   maps["peak_logits"])
            out["label_mismatch"] = max(out["label_mismatch"],
                                        float((lab != labels).sum()))
    return out


def check(cell, state, calibrated_on, inputs, scalars, twin_gap) -> list:
    got = readings(cell, state, calibrated_on, inputs, scalars)
    got["twin_label_mismatch"] = twin_gap
    limits = cell.spec["check"]["limits"]
    return [(k, got[k], limits[k]) for k in limits]
