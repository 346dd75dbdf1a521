"""The watershed resolve kernels (K2 chase, K3 flood) beside the variants that
were tried for them, on the card.

    python3 tpuseg_torch/tools/resolve_variants.py

Builds ``resolve_variants.cu`` (the committed kernels of ``csrc/`` and the
variants: the flood at other steps per launch and tiles, the chase with
other blocks and over a window of codes staged in shared memory, and the
package's chase pass at other z chunks: a pass that runs, an idle pass
timed alone, and the gated loop of 128 passes, on the load and on its
result, where every pass is idle) and, at
96x512x512 on two loads —
the analytic maps of the 600-instance synthetic stack and the probabilities
of the full default U-Net with seeded weights (the main path's load) — holds
every variant's pass of 8 steps and whole resolve against the package's
wrappers, elementwise, and times both (CUDA events after a warm-up); for
the flood also a pass on labels with nothing left open, which is the cost
of staging the planes through shared memory alone. Needs
``nvcc`` (``CUDA_HOME`` or /usr/local/cuda) and one GPU; prints a table and
``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent.parent))

from tpuseg_torch.ops import _build  # noqa: E402
from tpuseg_torch.ops import resolve  # noqa: E402

SHAPE = (96, 512, 512)
# planes a block of the package's chase pass walks (24: its rule at SHAPE on
# an H100, 4 chunks of 2048 tiles, about four waves; 1: a block a tile, the
# grid of K1's walk)
CHASE_ZCHUNKS = (1, 4, 12, 24, 48, 96)
CHASE_VARIANTS = {0: "walk through L1/L2, block 32x4x1 (K1's walk)",
                  1: "walk over a staged byte window, core 8x16x64, halo 8",
                  2: "walk, block 128x1x1", 3: "walk, block 32x8x1",
                  4: "walk, block 32x4x4", 5: "walk, block 32x8x4",
                  6: "walk, block 64x4x4", 7: "walk, block 256x1x1",
                  8: "walk, block 16x8x8"}
FLOOD_VARIANTS = {0: "4 steps a launch, tile 16x64",
                  1: "8 steps a launch, tile 16x64",
                  2: "8 steps a launch, tile 8x64",
                  3: "4 steps a launch, tile 32x64",
                  4: "4 steps a launch, tile 8x64",
                  5: "2 steps a launch, tile 16x64",
                  6: "4 steps a launch, tile 16x32",
                  7: "4 steps a launch, tile 16x128",
                  8: "4 steps a launch, tile 32x32 (committed)",
                  9: "4 steps a launch, tile 32x16",
                  10: "4 steps a launch, tile 24x24",
                  11: "4 steps a launch, tile 32x24",
                  12: "4 steps a launch, tile 24x32",
                  13: "4 steps a launch, tile 48x32",
                  14: "8 steps a launch, tile 32x32"}


def build(tmp: str) -> ctypes.CDLL:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    lib = Path(tmp) / "libresolve_variants.so"
    res = subprocess.run(
        [str(Path(home) / "bin" / "nvcc"), *_build.NVCC_FLAGS, "-shared",
         "-I", str(_build.CSRC), "-o", str(lib),
         str(ROOT / "resolve_variants.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())
    cdll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.variant_chase_pass.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    cdll.variant_flood_pass.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    cdll.variant_chase_zchunk.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
    cdll.variant_chase_resolve_zchunk.argtypes = [i, p, p, p, p, p, p, i, i,
                                                  i, i, i, p]
    return cdll


def cuda_ms(fn, reps: int) -> float:
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


def chase_variant(lib, variant):
    def chase_pass(values, dirs, fg_mask, iters=8):
        out = torch.empty_like(values)
        count = torch.empty((), dtype=torch.int32, device=values.device)
        d, h, w = values.shape
        _build.check(lib.variant_chase_pass(
            variant, values.data_ptr(), dirs.data_ptr(), fg_mask.data_ptr(),
            out.data_ptr(), count.data_ptr(), iters, d, h, w,
            _build.stream_ptr()), "variant_chase_pass")
        return out, count
    return chase_pass


def flood_variant(lib, variant):
    def flood_pass(pot, labels, iters=8):
        out, tmp = torch.empty_like(labels), torch.empty_like(labels)
        changed = torch.empty((), dtype=torch.int32, device=labels.device)
        d, h, w = labels.shape
        _build.check(lib.variant_flood_pass(
            variant, pot.data_ptr(), labels.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), changed.data_ptr(), iters, d, h, w,
            _build.stream_ptr()), "variant_flood_pass")
        return out, changed
    return flood_pass


def loads():
    """{name: (fg_prob, peak_prob)} float32 on the card."""
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import synthesize_volume
    from tpuseg_torch.infer import make_infer_stages
    from tpuseg_torch.models import build_model

    image = torch.from_numpy(synthesize_volume(
        shape=SHAPE, num_instances=600, seed=0).image).cuda()
    out = {"analytic maps": (torch.sigmoid((image - 0.35) * 25.0),
                             torch.sigmoid((image - 0.75) * 25.0))}
    cfg = Config()
    model = build_model(cfg.model, seed=0).cuda()
    logits = make_infer_stages(model, cfg)[1](image)
    out["seeded weights"] = (torch.sigmoid(logits["fg_logits"]).float(),
                             torch.sigmoid(logits["peak_logits"]).float())
    return out


def main() -> int:
    from tpuseg_torch.ops.seed import seed_chase_pass

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for load, (fg, pk) in loads().items():
            fgm = fg >= 0.5
            dirs, v = seed_chase_pass(pk, fg, 0.5, 0.5, (2, 2, 2))
            want_pass, _ = resolve.chase_pass(v, dirs, fgm, 8)
            want = resolve.chase_resolve(v, dirs, fgm)
            print(f"chase on the {load}, {SHAPE}:")
            print(f"  {'the package (chase_pass_kernel: tiles down z)':<55} "
                  f"pass of 8 "
                  f"{cuda_ms(lambda: resolve.chase_pass(v, dirs, fgm, 8), 10):7.3f}"
                  f" ms, resolve (gated) "
                  f"{cuda_ms(lambda: resolve.chase_resolve(v, dirs, fgm), 3):8.3f}"
                  " ms")
            zero = torch.zeros((), dtype=torch.int32, device=v.device)
            out = torch.empty_like(v)
            count = torch.empty((), dtype=torch.int32, device=v.device)

            def zchunk_pass(zc, gate):
                d, h, w = v.shape
                _build.check(lib.variant_chase_zchunk(
                    zc, v.data_ptr(), dirs.data_ptr(), fgm.data_ptr(),
                    out.data_ptr(), count.data_ptr(), gate, 8, d, h, w,
                    _build.stream_ptr()), "variant_chase_zchunk")
                return out

            b1, b2 = torch.empty_like(v), torch.empty_like(v)
            flags = torch.zeros(129, dtype=torch.int32, device=v.device)

            def zchunk_resolve(zc, vin):
                # resolve.chase_resolve's buffers and slots, 128 passes
                flags.zero_()
                flags[0].copy_((fgm & (vin == 0)).sum(dtype=torch.int32))
                d, h, w = v.shape
                _build.check(lib.variant_chase_resolve_zchunk(
                    zc, vin.data_ptr(), dirs.data_ptr(), fgm.data_ptr(),
                    b1.data_ptr(), b2.data_ptr(), flags.data_ptr(), 8, 128,
                    d, h, w, _build.stream_ptr()), "variant_chase_resolve")
                return b2

            ran = resolve.passes_run(resolve.chase_resolve.last_gates)
            for zc in CHASE_ZCHUNKS:
                if not (torch.equal(zchunk_pass(zc, None), want_pass)
                        and torch.equal(zchunk_resolve(zc, v), want)
                        and torch.equal(zchunk_resolve(zc, want), want)):
                    raise SystemExit(f"chase pass at zchunk {zc} is wrong")
                blocks = (-(-SHAPE[2] // 32) * -(-SHAPE[1] // 4)
                          * -(-SHAPE[0] // zc))
                print(f"  {f'the package, {zc} planes a block ({blocks} blocks)':<55}"
                      f" pass of 8 "
                      f"{cuda_ms(lambda: zchunk_pass(zc, None), 10):7.3f} ms, "
                      f"idle pass "
                      f"{1e3 * cuda_ms(lambda: zchunk_pass(zc, zero.data_ptr()), 100):7.2f} us; "
                      f"gated resolve ({ran} run) "
                      f"{cuda_ms(lambda: zchunk_resolve(zc, v), 5):7.3f} ms, "
                      f"all 128 idle "
                      f"{cuda_ms(lambda: zchunk_resolve(zc, want), 5):7.3f} ms")
            for variant, what in CHASE_VARIANTS.items():
                fn = chase_variant(lib, variant)
                got = resolve._chase_loop(fn, v, dirs, fgm, 8, 128)
                if not (torch.equal(fn(v, dirs, fgm, 8)[0], want_pass)
                        and torch.equal(got, want)):
                    raise SystemExit(f"chase variant {variant} is wrong")
                print(f"  {what:<55} pass of 8 "
                      f"{cuda_ms(lambda: fn(v, dirs, fgm, 8), 10):7.3f} ms, "
                      f"resolve {cuda_ms(lambda: resolve._chase_loop(fn, v, dirs, fgm, 8, 128), 3):8.3f} ms")
            seeds = want.clamp(min=0)
            pot = torch.where(fgm, fg, float("-inf"))
            lab0 = torch.where(fgm, seeds, 0).to(torch.int32)
            want = resolve.flood_resolve(seeds, fgm, fg, 96)
            want_pass = {n: resolve.flood_pass(pot, lab0, n)[0] for n in (8, 11)}
            full = torch.ones_like(lab0)
            print(f"flood on the {load}, {SHAPE}:")
            for variant, what in FLOOD_VARIANTS.items():
                fn = flood_variant(lib, variant)
                got = resolve._flood_loop(fn, seeds, fgm, fg, 96, 8)
                if not (all(torch.equal(fn(pot, lab0, n)[0], w)
                            for n, w in want_pass.items())
                        and torch.equal(got, want)):
                    raise SystemExit(f"flood variant {variant} is wrong")
                print(f"  {what:<55} pass of 8 "
                      f"{cuda_ms(lambda: fn(pot, lab0, 8), 10):7.3f} ms, "
                      f"resolve {cuda_ms(lambda: resolve._flood_loop(fn, seeds, fgm, fg, 96, 8), 3):8.3f} ms, "
                      f"pass of 8 with nothing open (staging alone) "
                      f"{cuda_ms(lambda: fn(pot, full, 8), 10):7.3f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
