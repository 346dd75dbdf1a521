"""Smoke run of the PyTorch/CUDA port (``tpuseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card: name, count, power limit (CUDA missing -> error);
2. build the hand-written kernels (K1 seed, K2 chase, K3 flood) from
   ``tpuseg_torch/csrc`` and print nvcc's per-kernel register report;
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
   ground truth.

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
NUM_INSTANCES = 600
SEED = 0

KERNELS = {  # wrapper name -> (CUDA source, the TPU kernel it replaces)
    "seed_chase_pass": ("tpuseg_torch/csrc/seed.cu",
                        "tpuseg/ops/pallas_seed.py:205"),
    "chase_pass": ("tpuseg_torch/csrc/resolve.cu",
                   "tpuseg/ops/pallas_resolve.py:167"),
    "flood_pass": ("tpuseg_torch/csrc/resolve.cu",
                   "tpuseg/ops/pallas_resolve.py:291"),
}


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


def phase_main_path(image: np.ndarray, tmp: str):
    from tpuseg_torch.cli import infer as cli_infer
    from tpuseg_torch.core import Config
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    cfg = Config()
    ckpt = os.path.join(tmp, "seeded.pth")
    vol_path = os.path.join(tmp, "volume.npy")
    out_path = os.path.join(tmp, "labels.npy")
    write_seeded_checkpoint(ckpt, cfg.model)
    np.save(vol_path, image)

    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    status = cli_infer.main(["--checkpoint", ckpt, "--input", vol_path,
                             "--output", out_path, "--report-convergence"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[4] cli.infer exit status {status} "
          f"({'flood truncated' if status == 4 else 'converged'}); "
          f"kernel launches {launches}")
    if status not in (0, 4):
        raise AssertionError(f"cli.infer returned {status}")
    missing = [k for k, n in launches.items() if n == 0]
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


def main():
    name, smi = phase_device()
    phase_build()
    from tpuseg_torch.data import synthesize_volume

    sv = synthesize_volume(shape=MAIN_SHAPE, num_instances=NUM_INSTANCES,
                           seed=SEED)
    kernels = phase_kernels(sv.image)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ckpt, cfg = phase_main_path(sv.image, tmp)
        phase_warm_stages(sv.image, ckpt, cfg)
    phase_analytic(sv)

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
