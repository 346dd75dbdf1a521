"""Where the time of the tensor-core conv kernels (K6, K4) goes: an ablation
on the card.

    python3 tpuseg_torch/tools/conv_ablate.py

Builds the kernels as they are and in patched copies that leave one part
out — ``nostage`` never refreshes the staged input after the prologue,
``nostore`` never writes the output (the results are wrong; only the time
means anything) — and times each through ``conv_ablate.cu`` at the main
paths' shapes: K6 at (8, ci, 64^3) -> 32 channels, K4 at (1, ci, 64, 160,
160), bf16. The difference from ``base`` is what the part costs as the
kernel stands, overlap included. Needs ``nvcc`` (``CUDA_HOME`` or
/usr/local/cuda) and one GPU; prints a table and ``nvidia-smi``'s name and
power limit. A patch whose text is no longer in the source fails loudly:
bring it up to date with the kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

# variant -> {source file: [(text, replacement)]}
PATCHES = {
    "base": {},
    "nostage": {
        "convtrain.cu": [("    store_plane(z + 2);\n    load_plane(z + 3);\n",
                          "")],
        "convblock.cu": [("            store_piece(pc + 1);\n"
                          "            load_piece(pc + 2);\n", "")],
    },
    "nostore": {
        # a condition no sum meets keeps the accumulators alive
        "convtrain.cu": [("if (gx < W && gy < H)",
                          "if (gx < W && gy < H && acc[t][i] == 123456.f)")],
        "convblock.cu": [
            ("if (col >= kMOutX || gy >= H || gx >= W) continue;",
             "if (col >= kMOutX || gy >= H || gx >= W || "
             "acc[t][0] != 123456.f) continue;")],
    },
}
PATCHES["nostage_nostore"] = {
    f: PATCHES["nostage"][f] + PATCHES["nostore"][f]
    for f in ("convtrain.cu", "convblock.cu")}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, patches in PATCHES.items():
            out = Path(tmp) / name
            out.mkdir()
            for src in ("conv_mma.cuh", "convtrain.cu", "convblock.cu"):
                text = (CSRC / src).read_text()
                for old, new in patches.get(src, []):
                    if old not in text:
                        raise SystemExit(f"{name}: {src} no longer has {old!r}")
                    text = text.replace(old, new)
                (out / src).write_text(text)
            builds[name] = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(out / "bench"),
                 str(ROOT / "conv_ablate.cu"), str(out / "convtrain.cu"),
                 str(out / "convblock.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in builds.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
        times = {}
        for name in PATCHES:
            res = subprocess.run([str(Path(tmp) / name / "bench"), name],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"{name}: {res.stdout}{res.stderr}")
            for line in res.stdout.splitlines():
                _, case, ms = line.split()
                times.setdefault(case, {})[name] = float(ms)
    print(f"{'case':<12}" + "".join(f"{n:>18}" for n in PATCHES) + "   (ms)")
    for case, row in times.items():
        print(f"{case:<12}" + "".join(f"{row[n]:>18.3f}" for n in PATCHES))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
