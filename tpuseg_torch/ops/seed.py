"""Watershed seeding: peak NMS + steepest-ascent direction codes + signed root
payloads + the first chase steps (K1; port of ``tpuseg/ops/pallas_seed.py``).

``seed_chase_pass`` computes, for the index label space,

  fg    = fg_prob >= fg_thr
  seeds = peak-NMS(peak, peak_thr, radius) & fg        (ops/peaks semantics)
  dirs  = steepest_dir_codes(peak, fg, self_sticky=seeds)
  v0    = +lin+1 at seeded roots, -(lin+1) at unseeded roots, 0 elsewhere
  v     = h0 lockstep chase steps of V[x] <- V[x + offset(dirs[x])]

and returns ``(dirs, v)``, the state ``resolve.chase_resolve`` continues
from. A CUDA tensor runs the hand-written kernels of ``csrc/seed.cu`` (any
shape: no block guard, no fallback); a CPU tensor runs
:func:`seed_chase_pass_plain`, the unfused composition above.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.neighbors import linear_index
from tpuseg_torch.ops.peaks import peak_nms, radius3
from tpuseg_torch.ops.resolve import chase_steps_plain
from tpuseg_torch.ops.watershed import steepest_dir_codes


def seed_chase_pass_plain(peak_prob, fg_prob, peak_threshold, fg_threshold,
                          radius=(2, 2, 2), h0: int = 8):
    """Twin of :func:`seed_chase_pass` in plain PyTorch, on any device."""
    peak = peak_prob.float()
    fg = fg_prob.float() >= fg_threshold
    seeds = peak_nms(peak, peak_threshold, radius) & fg
    dirs = steepest_dir_codes(peak, fg, self_sticky=seeds)
    idx = linear_index(peak.shape, peak.device)
    v0 = torch.where(fg & (dirs == 0), torch.where(seeds, idx + 1, -(idx + 1)),
                     0).to(torch.int32)
    return dirs, chase_steps_plain(v0, dirs, h0)


def seed_chase_pass(peak_prob, fg_prob, peak_threshold, fg_threshold,
                    radius=(2, 2, 2), h0: int = 8):
    """``(dirs, v)``: int32 direction codes and chase payloads after ``h0``
    lockstep chase steps. Both maps are taken as float32 (the TPU kernel's
    cast point); thresholds are float32 scalars."""
    if peak_prob.device.type == "cpu":
        return seed_chase_pass_plain(peak_prob, fg_prob, peak_threshold,
                                     fg_threshold, radius, h0)
    rz, ry, rx = radius3(radius)
    peak = peak_prob.to(torch.float32).contiguous()
    fgp = fg_prob.to(torch.float32).contiguous()
    _build.check_volume(peak, fgp)

    def ivol():
        return torch.empty(peak.shape, dtype=torch.int32, device=peak.device)

    f0, f1 = torch.empty_like(peak), torch.empty_like(peak)
    cidx, i0, i1, dirs, v, vtmp = (ivol() for _ in range(6))
    d, h, w = peak.shape
    err = _build.load().tpuseg_seed_chase(
        peak.data_ptr(), fgp.data_ptr(), float(peak_threshold),
        float(fg_threshold), rz, ry, rx, h0, d, h, w,
        f0.data_ptr(), f1.data_ptr(), cidx.data_ptr(), i0.data_ptr(),
        i1.data_ptr(), dirs.data_ptr(), v.data_ptr(), vtmp.data_ptr(),
        _build.stream_ptr())
    _build.check(err, "seed_chase_pass")
    seed_chase_pass.launches += 1
    return dirs, v


seed_chase_pass.launches = 0
