"""Smoke run of the PyTorch/CUDA port (``tpuseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card: name, count, power limit (CUDA missing -> error);
2. build the hand-written kernels (K1 seed, K2 chase, K3 flood, K6 training
   conv) from ``tpuseg_torch/csrc`` and print nvcc's per-kernel register
   report;
3. each kernel against its plain PyTorch twin on the card, elementwise, at
   the main-path shape 96x512x512 (analytic maps of a 600-instance
   synthetic stack) and at a ragged shape; kernel and twin times (CUDA
   events, after a warm-up) at 96x512x512;
4. the main path through its entry point: ``tpuseg_torch.cli.infer.main`` on
   a 96x512x512 volume with seeded weights of the full default U-Net
   (32/64/128/256, head 32, bf16) under the default InferConfig; every
   kernel's launch counter must be above 0 after the run; then, warm, the
   stage times, and its post-processing through the twins on the same
   logits: labels equal elementwise;
5. the analytic-net pipeline on the same stack, once through the kernels and
   once through the twins: labels equal elementwise; F1@IoU0.5 against the
   ground truth;
6. K6 forward and dx against ``F.conv3d`` at the training shapes
   (8, ci, 64^3), ci in {1, 32, 64}, and at (3, ci, 13, 27, 45), in f32
   (TF32 off) and bf16; kernel and twin times (bf16) at the full shapes;
7. the training main path through its entry point:
   ``tpuseg_torch.cli.train.main`` on the full default U-Net, batch 8 of
   64^3, ``train.apply_impl="fused"``, two synthetic volumes (one held out
   for validation with val-volume inference); K6 and K1-K3 launch counters
   above 0, finite losses, the checkpoint written, and a ``--resume`` run
   that continues from it;
8. the fused and the plain-module train step on one fixed batch: loss and
   every parameter gradient (f32 and bf16 bounds in the phase);
9. bench.py's 200-step trained-weights recipe through
   ``tpuseg_torch.train.train`` (fused), then ``cli.infer`` with that
   checkpoint on the 96x512x512 stack, default and calibrated
   (``--calibrate-from``): the loss must halve and the calibrated
   F1@IoU0.5 reach 0.5.

The second-to-last lines are the kernels' JSON record and nvidia-smi's
``name, power.limit``; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch import nn

MAIN_SHAPE = (96, 512, 512)
RAGGED_SHAPE = (45, 203, 301)
TRAIN_SHAPE = (8, 64, 64, 64)           # batch 8 of 64^3 patches
RAGGED_CONV_SHAPE = (3, 13, 27, 45)
NUM_INSTANCES = 600
SEED = 0

KERNELS = {  # wrapper name -> (CUDA source, the TPU kernel it replaces)
    "seed_chase_pass": ("tpuseg_torch/csrc/seed.cu",
                        "tpuseg/ops/pallas_seed.py:205"),
    "chase_pass": ("tpuseg_torch/csrc/resolve.cu",
                   "tpuseg/ops/pallas_resolve.py:167"),
    "flood_pass": ("tpuseg_torch/csrc/resolve.cu",
                   "tpuseg/ops/pallas_resolve.py:291"),
    "conv3x3_raw": ("tpuseg_torch/csrc/convtrain.cu",
                    "tpuseg/ops/pallas_convtrain.py:231"),
}
INFER_KERNELS = ("seed_chase_pass", "chase_pass", "flood_pass")
TRAIN_STEPS, RESUME_STEPS = 20, 24       # the train main path, then a resume
QUALITY_STEPS = 200                      # bench.py's trained-weights recipe


class AnalyticNet(nn.Module):
    """Pointwise logits from blob intensities (receptive field 0): the
    stand-in the JAX package's pipeline tests use, as a torch module."""

    def forward(self, x):
        v = x[:, 0].float()
        return {"fg_logits": (v - 0.35) * 25.0, "peak_logits": (v - 0.75) * 25.0}


def analytic_maps(image: np.ndarray, device):
    """(fg_prob, peak_prob) float32 of AnalyticNet on an image in [0, 1]."""
    v = torch.from_numpy(image).to(device)
    return torch.sigmoid((v - 0.35) * 25.0), torch.sigmoid((v - 0.75) * 25.0)


def write_seeded_checkpoint(path: str, model_cfg, seed: int = SEED) -> None:
    """A mirror-named ``.pth`` with seeded weights of ``model_cfg``."""
    from tpuseg_torch.models import build_model

    torch.save(build_model(model_cfg, seed=seed).state_dict(), path)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    between CUDA events on the current stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1] device: {name} x{torch.cuda.device_count()}; {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return name, smi


def phase_build():
    from tpuseg_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"[2] kernels built/loaded in {time.perf_counter() - t0:.1f}s "
          f"({_build.build_dir()})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("    " + line.strip())


def compare_kernels(fg, pk, timed: bool):
    """K1-K3 against their twins on one pair of maps; returns per kernel
    (max_abs_err, ms, plain_ms)."""
    from tpuseg_torch.ops.resolve import (chase_resolve, chase_resolve_plain,
                                          flood_resolve, flood_resolve_plain)
    from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

    thr, radius, flood_iters = 0.5, (2, 2, 2), 96
    fgm = fg >= thr
    runs = {
        "seed_chase_pass": (
            lambda: seed_chase_pass(pk, fg, thr, thr, radius),
            lambda: seed_chase_pass_plain(pk, fg, thr, thr, radius)),
    }
    dirs, v = seed_chase_pass_plain(pk, fg, thr, thr, radius)
    runs["chase_pass"] = (lambda: chase_resolve(v, dirs, fgm),
                          lambda: chase_resolve_plain(v, dirs, fgm))
    v_res = chase_resolve_plain(v, dirs, fgm).clamp(min=0)
    runs["flood_pass"] = (
        lambda: flood_resolve(v_res, fgm, fg, flood_iters),
        lambda: flood_resolve_plain(v_res, fgm, fg, flood_iters))
    out = {}
    for name, (kern, plain) in runs.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err != 0:
            raise AssertionError(f"{name}: kernel != twin at {tuple(fg.shape)} "
                                 f"(max abs err {err})")
        ms = cuda_ms(kern, 5) if timed else None
        plain_ms = cuda_ms(plain, 2) if timed else None
        out[name] = (err, ms, plain_ms)
    return out


def phase_kernels(image: np.ndarray):
    from tpuseg_torch.data import synthesize_volume

    fg, pk = analytic_maps(image, "cuda")
    main = compare_kernels(fg, pk, timed=True)
    ragged = synthesize_volume(shape=RAGGED_SHAPE, num_instances=40,
                               seed=SEED + 1).image
    rag = compare_kernels(*analytic_maps(ragged, "cuda"), timed=False)
    for name, (err, ms, plain_ms) in main.items():
        print(f"[3] {name}: == twin at {MAIN_SHAPE} and {RAGGED_SHAPE}; "
              f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms at {MAIN_SHAPE}")
    return {k: (max(main[k][0], rag[k][0]),) + main[k][1:] for k in main}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bfloat16 ulp of each |v| (8-bit significand)."""
    _, e = torch.frexp(v.abs().float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def check_conv(name, got, want, dtype) -> float:
    """Max abs error of the K6 kernel against its twin; raises beyond the
    bounds.

    float32 (TF32 off in the twin): every element within 1e-4 of the
    output's max magnitude (summation order only). bfloat16: every element
    within 2 bf16 ulps of its own magnitude, the magnitude floored at 2^-8
    of the output's max (below that, f32 accumulation-order differences
    under cancellation exceed an ulp of the tiny result), and the max abs
    error within 2 ulps of the max magnitude."""
    err = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    max_err = float(err.max())
    if dtype == torch.float32:
        ok = max_err <= 1e-4 * top
    else:
        floor = torch.clamp(want.float().abs(), min=top * 2.0 ** -8)
        ok = (bool((err <= 2 * bf16_ulp(floor)).all())
              and max_err <= 2 * float(bf16_ulp(torch.tensor(top))))
    if not ok:
        raise AssertionError(f"{name}: kernel != twin (max abs err "
                             f"{max_err:.3g}, max |y| {top:.3g})")
    return max_err


def phase_conv():
    """K6 forward and dx against the twin (F.conv3d), f32 and bf16, at the
    train path's full-width shapes and a ragged one; kernel and twin times
    (bf16, CUDA events) at the full-width shapes."""
    from tpuseg_torch.ops.convtrain import conv3x3_raw, conv3x3_raw_plain, flip_w

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, times = 0.0, {}
    for shape in (TRAIN_SHAPE, RAGGED_CONV_SHAPE):
        n, sp = shape[0], shape[1:]
        for ci in (1, 32, 64):
            w32 = torch.randn((32, ci, 3, 3, 3), device="cuda", generator=g) \
                / (27 * ci) ** 0.5
            x32 = torch.randn((n, ci, *sp), device="cuda", generator=g)
            dy32 = torch.randn((n, 32, *sp), device="cuda", generator=g)
            for dtype in (torch.float32, torch.bfloat16):
                x, w, dy = x32.to(dtype), w32.to(dtype), dy32.to(dtype)
                wf = flip_w(w).contiguous()
                for what, (a, b) in {"fwd": (x, w), "dx": (dy, wf)}.items():
                    tag = f"conv3x3 {what} ci={ci} {tuple(shape)} {dtype}"
                    got = conv3x3_raw(a, b)
                    want = conv3x3_raw_plain(a, b)
                    torch.cuda.synchronize()
                    worst = max(worst, check_conv(tag, got, want, dtype))
                    if shape == TRAIN_SHAPE and dtype == torch.bfloat16:
                        times[(what, ci)] = (
                            cuda_ms(lambda: conv3x3_raw(a, b), 5),
                            cuda_ms(lambda: conv3x3_raw_plain(a, b), 5))
            del x32, dy32
    for (what, ci), (ms, plain_ms) in times.items():
        print(f"[6] conv3x3 {what} ci={ci} {TRAIN_SHAPE} bf16: kernel "
              f"{ms:.3f} ms, twin {plain_ms:.3f} ms")
    print(f"[6] conv3x3 == twin (fwd and dx, f32 and bf16) at {TRAIN_SHAPE} "
          f"and {RAGGED_CONV_SHAPE}, ci in (1, 32, 64); max abs err {worst:.3g}")
    return worst, times


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _reset_launches():
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def _launches():
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def phase_main_path(image: np.ndarray, tmp: str):
    from tpuseg_torch.cli import infer as cli_infer
    from tpuseg_torch.core import Config

    cfg = Config()
    ckpt = os.path.join(tmp, "seeded.pth")
    vol_path = os.path.join(tmp, "volume.npy")
    out_path = os.path.join(tmp, "labels.npy")
    write_seeded_checkpoint(ckpt, cfg.model)
    np.save(vol_path, image)

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    status = cli_infer.main(["--checkpoint", ckpt, "--input", vol_path,
                             "--output", out_path, "--report-convergence"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[4] cli.infer exit status {status} "
          f"({'flood truncated' if status == 4 else 'converged'}); "
          f"kernel launches {launches}")
    if status not in (0, 4):
        raise AssertionError(f"cli.infer returned {status}")
    missing = [k for k in INFER_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    labels = np.load(out_path)
    ids = np.unique(labels)
    if (labels.shape != MAIN_SHAPE or labels.dtype != np.int32
            or not np.array_equal(ids, np.arange(ids.size))):
        raise AssertionError(f"bad labels: {labels.shape} {labels.dtype} "
                             f"ids {ids[:5]}...{ids[-5:]}")
    n_inst = int(ids.size - 1)
    vox = int(np.prod(MAIN_SHAPE))
    print(f"[4] main path: {n_inst} instances; wall {wall:.3f} s incl. "
          f"first-call setup ({vox / wall / 1e6:.2f} Mvox/s); peak device "
          f"memory {peak_gb:.2f} GB")
    return launches, ckpt, cfg


def phase_warm_stages(image: np.ndarray, ckpt: str, cfg):
    """The same main path, warm, timed per stage; then its post-processing
    again through the plain twins on the same logits: labels must agree."""
    from tpuseg_torch.ckpt import load_pth
    from tpuseg_torch.infer import make_infer_stages
    from tpuseg_torch.models import build_model

    model = build_model(cfg.model)
    model.load_state_dict(load_pth(ckpt))
    model.cuda()
    _, stage_net, stage_post = make_infer_stages(model, cfg)
    vol = torch.from_numpy(image).cuda()
    stage_post(stage_net(vol))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = stage_net(vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    labels = stage_post(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    vox = int(np.prod(MAIN_SHAPE))
    print(f"[4] warm: net sweep {1e3 * (t1 - t0):.1f} ms, post {1e3 * (t2 - t1):.1f}"
          f" ms, total {1e3 * (t2 - t0):.1f} ms ({vox / (t2 - t0) / 1e6:.2f} Mvox/s)")
    for k, v in logits.items():
        if v.shape != MAIN_SHAPE or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: shape {tuple(v.shape)} or non-finite")
    plain = make_infer_stages(model, cfg, plain=True)[2](logits)
    if not torch.equal(labels, plain):
        raise AssertionError(f"main path: kernels != twins on "
                             f"{int((labels != plain).sum())} voxels")
    print(f"[4] main-path post-processing: kernels == twins elementwise "
          f"({int(labels.max())} instances)")


def phase_analytic(sv):
    from tpuseg_torch.core import Config, InferConfig
    from tpuseg_torch.eval import instance_metrics
    from tpuseg_torch.infer import make_infer_stages

    cfg = Config(infer=InferConfig(compute_dtype="float32"))
    vol = torch.from_numpy(sv.image).cuda()
    got = make_infer_stages(AnalyticNet(), cfg)[0](vol).cpu().numpy()
    want = make_infer_stages(AnalyticNet(), cfg, plain=True)[0](vol).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"analytic pipeline: kernels != twins on "
                             f"{int((got != want).sum())} voxels")
    m = instance_metrics(got, sv.labels, iou_threshold=0.5)
    c = instance_metrics(got, sv.labels, criterion="center")
    print(f"[5] analytic pipeline: kernels == twins elementwise; "
          f"{m['n_pred']} instances vs {m['n_gt']} GT, F1@IoU0.5 "
          f"{m['f1']:.4f}, center-hit F1 {c['f1']:.4f}")


def phase_train_main_path(tmp: str):
    """``tpuseg_torch.cli.train.main`` on the full default model, batch 8 of
    64^3, fused apply, two synthetic volumes (one held out), validation
    with val-volume inference; then a ``--resume`` run continues it."""
    from tpuseg_torch.cli import train as cli_train

    ckpt_dir = os.path.join(tmp, "train_ckpt")
    log = os.path.join(tmp, "train.jsonl")
    common = ["--device", "cuda", "--synthetic", "2", "--log", log,
              "--set", 'train.apply_impl="fused"',
              "--set", f"train.ckpt_dir={json.dumps(ckpt_dir)}",
              "--set", "train.log_every=5", "--set", "train.warmup_steps=5",
              "--set", "train.val_fraction=0.5", "--set", "train.val_every=10",
              "--set", "train.val_patches=8", "--set", "train.val_f1=true",
              "--set", "train.ckpt_every=10"]
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli_train.main(common + ["--set", f"train.total_steps={TRAIN_STEPS}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"train main path never launched {missing}")
    recs = _read_jsonl(log)
    train_recs = [r for r in recs if "loss" in r]
    val_recs = [r for r in recs if "val_loss" in r]
    losses = [r["loss"] for r in train_recs]
    if (len(train_recs) != TRAIN_STEPS // 5 or not np.isfinite(losses).all()
            or not all(np.isfinite(r["val_loss"]) for r in val_recs)
            or len(val_recs) != 2 or "val_center_f1" not in val_recs[-1]):
        raise AssertionError(f"train main path: bad log {recs}")
    from tpuseg_torch.ckpt import CheckpointManager

    if CheckpointManager(ckpt_dir).latest_step() != TRAIN_STEPS:
        raise AssertionError("train main path: no checkpoint at the last step")
    steady = train_recs[-1]["mvox_per_s"]
    vox = int(np.prod(TRAIN_SHAPE))
    print(f"[7] cli.train: {TRAIN_STEPS} steps, batch {TRAIN_SHAPE}, fused "
          f"apply; wall {wall:.1f} s incl. set-up and 2 validations; "
          f"losses {[round(x, 4) for x in losses]}; val "
          f"{[(r['step'], round(r['val_loss'], 4), round(r['val_center_f1'], 4)) for r in val_recs]}; "
          f"kernel launches {launches}")
    print(f"[7] steady train step: {steady:.3f} Mvox/s = "
          f"{1e3 * vox / 1e6 / steady:.1f} ms/step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    n_before = len(recs)
    cli_train.main(common + ["--resume", "--set",
                             f"train.total_steps={RESUME_STEPS}"])
    resumed = [r for r in _read_jsonl(log)[n_before:] if "loss" in r]
    if (CheckpointManager(ckpt_dir).latest_step() != RESUME_STEPS
            or [r["step"] for r in resumed] != [RESUME_STEPS]):
        raise AssertionError(f"resume did not continue from step "
                             f"{TRAIN_STEPS}: {resumed}")
    print(f"[7] --resume continued {TRAIN_STEPS} -> {RESUME_STEPS} "
          f"(loss {resumed[-1]['loss']:.4f})")
    return launches


def phase_fused_vs_plain():
    """One fixed batch through the fused train step and the plain-module
    step on the same weights (TF32 off): loss and every parameter gradient.

    float32: loss and every gradient tensor within 2e-3 of its max
    magnitude (summation order: the K6 convs against cuDNN's, the heads'
    float32 contraction against the module conv). bfloat16: the two paths
    round at different points (the fused heads stay float32, the module
    heads add their bias in bf16), and a gradient that sums many bf16-noisy
    terms to a small total (a bias, a BatchNorm shift) differs by tens of
    percent elementwise; so loss within 1e-3, every gradient tensor within
    0.3 relative L2 error, and the whole gradient within 0.05 — a wrong
    kernel or a dropped term gives errors of order 1."""
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import PatchSampler, synthesize_volume
    from tpuseg_torch.models import build_model
    from tpuseg_torch.models.fused_train import make_fused_train_apply
    from tpuseg_torch.train.step import loss_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    vol = synthesize_volume(shape=(64, 128, 128), num_instances=16, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in PatchSampler(
        [vol], batch_size=TRAIN_SHAPE[0]).next_batch().items()}
    for dtype in ("float32", "bfloat16"):
        cfg = Config().override(**{"model.compute_dtype": dtype})
        grads, losses = [], []
        for fused in (True, False):
            model = build_model(cfg.model, seed=SEED).cuda().train()
            apply_fn = make_fused_train_apply(model) if fused else None
            loss, _ = loss_fn(model, batch, cfg, 1, 0, 0, apply_fn)
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({k: p.grad for k, p in model.named_parameters()})
        got, want = grads
        rel_max = {k: float((got[k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-12) for k, g in want.items()}
        rel_l2 = {k: float((got[k] - g).norm()) / max(float(g.norm()), 1e-12)
                  for k, g in want.items()}
        total = (sum(float((got[k] - g).square().sum()) for k, g in want.items())
                 / sum(float(g.square().sum()) for g in want.values())) ** 0.5
        loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
        worst = sorted(rel_l2, key=rel_l2.get, reverse=True)[:3]
        print(f"[8] fused vs plain step ({dtype}): loss {losses[0]:.6f} vs "
              f"{losses[1]:.6f} (rel {loss_rel:.2e}); gradients: worst max-rel "
              f"{max(rel_max.values()):.2e}, worst rel-L2 "
              f"{[(k, round(rel_l2[k], 4)) for k in worst]}, whole {total:.2e}")
        if dtype == "float32":
            ok = loss_rel <= 2e-3 and max(rel_max.values()) <= 2e-3
        else:
            ok = (loss_rel <= 1e-3 and max(rel_l2.values()) <= 0.3
                  and total <= 0.05)
        if not ok:
            raise AssertionError(f"fused and plain train steps disagree "
                                 f"({dtype})")


def phase_trained_quality(sv, tmp: str):
    """bench.py's trained-weights recipe through the port (fused apply):
    200 steps, lr 1e-3, warmup 20, z-scale augmentation (0.5, 1.0),
    anisotropic peak sigma, on two 64x192x192 volumes of 60 instances
    (seeds 42, 43); then ``cli.infer`` with the checkpoint on the
    96x512x512 600-instance stack, under default post-processing and
    calibrated from the stack's weak annotations (``--calibrate-from``: the
    volume-matched fg threshold that undoes box supervision's ~2x mask
    inflation, as bench.py's c3 does). The calibrated F1@IoU0.5 must
    reach 0.5; the default one is printed."""
    from tpuseg_torch.cli import infer as cli_infer
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import save_annotations, synthesize_volume
    from tpuseg_torch.eval import instance_metrics
    from tpuseg_torch.train import train

    ckpt_dir = os.path.join(tmp, "quality_ckpt")
    cfg = Config().override(**{
        "data.aug_zscale": [0.5, 1.0], "data.peak_sigma_aniso": True,
        "train.total_steps": QUALITY_STEPS, "train.warmup_steps": 20,
        "train.lr": 1e-3, "train.log_every": 10, "train.ckpt_every": 100_000,
        "train.apply_impl": "fused", "train.ckpt_dir": ckpt_dir})
    vols = [synthesize_volume(shape=(64, 192, 192), num_instances=60, seed=s)
            for s in (42, 43)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = train(cfg, vols, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    mvox = float(np.median([h["mvox_per_s"] for h in history[1:]]))
    steps_s = mvox * 1e6 / int(np.prod(TRAIN_SHAPE))
    print(f"[9] trained {QUALITY_STEPS} steps in {train_s:.1f} s incl. "
          f"set-up: {steps_s:.2f} steps/s, {mvox:.3f} Mvox/s (median of "
          f"10-step windows); peak device memory {peak_gb:.2f} GB; loss "
          f"{losses[0]:.4f} (step 10) -> {losses[-1]:.4f} (step {QUALITY_STEPS})")
    if not np.isfinite(losses).all() or not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"trained quality: loss did not halve {losses}")

    vol_path = os.path.join(tmp, "stack.npy")
    ann_path = os.path.join(tmp, "stack_annotations.npz")
    np.save(vol_path, sv.image)
    save_annotations(ann_path, sv.centers, sv.half_sizes)
    f1 = {}
    for tag, extra in (("default", []), ("calibrated",
                                         ["--calibrate-from", ann_path])):
        out_path = os.path.join(tmp, f"labels_{tag}.npy")
        t0 = time.perf_counter()
        status = cli_infer.main(["--checkpoint", ckpt_dir, "--input",
                                 vol_path, "--output", out_path, *extra])
        wall = time.perf_counter() - t0
        labels = np.load(out_path)
        m = instance_metrics(labels, sv.labels, iou_threshold=0.5)
        c = instance_metrics(labels, sv.labels, criterion="center")
        f1[tag] = m["f1"]
        print(f"[9] cli.infer, trained checkpoint, {tag} post-processing, "
              f"{MAIN_SHAPE}: status {status}, {m['n_pred']} instances vs "
              f"{m['n_gt']} GT, F1@IoU0.5 {m['f1']:.4f}, center F1 "
              f"{c['f1']:.4f} "
              f"(wall {wall:.1f} s incl. set-up)")
        if status != 0:
            raise AssertionError(f"cli.infer returned {status}")
    if f1["calibrated"] < 0.5:
        raise AssertionError(f"trained quality: calibrated F1@IoU0.5 "
                             f"{f1['calibrated']:.4f} < 0.5")


def _timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"    ({label}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main():
    name, smi = phase_device()
    phase_build()
    from tpuseg_torch.data import synthesize_volume

    sv = synthesize_volume(shape=MAIN_SHAPE, num_instances=NUM_INSTANCES,
                           seed=SEED)
    kernels = _timed("phase 3", phase_kernels, sv.image)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ckpt, cfg = _timed("phase 4", phase_main_path, sv.image, tmp)
        _timed("phase 4 warm", phase_warm_stages, sv.image, ckpt, cfg)
    _timed("phase 5", phase_analytic, sv)
    conv_err, conv_times = _timed("phase 6", phase_conv)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = _timed("phase 7", phase_train_main_path, tmp)
    _timed("phase 8", phase_fused_vs_plain)
    with tempfile.TemporaryDirectory() as tmp:
        _timed("phase 9", phase_trained_quality, sv, tmp)

    ms, plain_ms = conv_times[("fwd", 32)]
    kernels["conv3x3_raw"] = (conv_err, ms, plain_ms)
    launches["conv3x3_raw"] = train_launches["conv3x3_raw"]
    record = [{"name": k, "route": "cuda", "source": KERNELS[k][0],
               "replaces": KERNELS[k][1], "launches": launches[k],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
              for k, (err, ms, plain_ms) in kernels.items()]
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
