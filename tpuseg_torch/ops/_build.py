"""Build and load the hand-written CUDA kernels (``tpuseg_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface, loaded with ``ctypes`` — seconds to build, against minutes for a
source that includes PyTorch's headers. The build runs at first use, into
``tpuseg_torch/_build/<hash>/`` where the hash covers the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is loaded as is.
A failed build raises: there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of csrc/*.cu's entry points; every pointer and the stream are
# void* so ctypes never truncates them to 32 bits
SIGNATURES = {
    "tpuseg_seed_chase": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P],
    "tpuseg_seed_chase_chain": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P, _P, _P, _P],
    "tpuseg_chase_pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tpuseg_chase_resolve": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tpuseg_flood_steps_per_launch": [],
    "tpuseg_flood_pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tpuseg_flood_resolve": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tpuseg_conv3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tpuseg_conv3x3_mma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tpuseg_convblock": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    "tpuseg_convblock_mma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P],
    "tpuseg_peak_nms": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "tpuseg_peak_nms_chain": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P, _P, _P],
    "tpuseg_nms_tile_max_radius": [],
    "tpuseg_nms_tile_smem": [_I, _I],
    "tpuseg_smem_optin": [],
    "tpuseg_bin_counts": [_P, _L, _I, _P, _P, _I, _I, _P, _P],
    "tpuseg_percentiles": [_P, _I, _I, _L, _P, _P, _P, _I, _P, _P],
    "tpuseg_label_counts": [_P, _L, _P, _P],
    "tpuseg_union_closure": [_P, _P, _L, _P, _P, _P, _L, _I, _P],
    "tpuseg_pair_aggregate": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _L, _P],
    "tpuseg_pair_select": [_P, _P, _P, _P, _P, _P, _L, _L, _P],
    "tpuseg_pair_slots": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _F, _L, _L,
                          _P, _P, _P, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of tpuseg_torch are built from source at first use")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    out = build_dir()
    lib_path = out / "libtpuseg_kernels.so"
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = os.getpid()
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [out / f"{s.stem}.{tag}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        tmp = out / f"libtpuseg_kernels.{tag}.so"
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                   str(tmp),
                                   *(str(o) for o in objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        log = "".join(logs)
        (out / "build.log").write_text(log)
        for o in objs:
            o.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) from the build :func:`load` made or found."""
    log = build_dir() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.cache
def smem_optin() -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of the current device: the
    dynamic shared memory a block may opt in to (232,448 bytes on an H100)."""
    n = load().tpuseg_smem_optin()
    check(max(-n, 0), "cudaDeviceGetAttribute(MaxSharedMemoryPerBlockOptin)")
    return n


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def device_scalars(*values, device) -> torch.Tensor:
    """A float32 device vector of ``values`` (floats or 0-d tensors, on any
    device), for kernels that read their thresholds from device memory:
    each entry is a fill or a device copy, never a blocking host copy
    (``out[i] = 0.5`` would copy a host scalar and wait for the device)."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            out[i].copy_(v.reshape(()))
        else:
            out[i].fill_(float(v))
    return out


def check_volume(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous (D, H, W) CUDA volumes of one shape with
    D, H <= 65535 (grid y/z) and D*H*W < 2**31 (labels are lin + 1 in int32)."""
    shape = tensors[0].shape
    for t in tensors:
        if not t.is_cuda or t.dim() != 3 or t.shape != shape:
            raise ValueError(f"kernel needs CUDA (D, H, W) volumes of one "
                             f"shape; got {t.device} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous volumes")
    d, h, w = shape
    if d > 65535 or h > 65535 or d * h * w >= 2 ** 31:
        raise ValueError(f"volume {tuple(shape)} exceeds the kernels' index "
                         "range (D, H <= 65535, D*H*W < 2**31)")
