"""Watershed seeding: peak NMS + steepest-ascent direction codes + signed root
payloads + the first chase steps (K1; port of ``tpuseg/ops/pallas_seed.py``).

``seed_chase_pass`` computes, for the index label space,

  fg    = fg_prob >= fg_thr
  seeds = peak-NMS(peak, peak_thr, radius) & fg        (ops/peaks semantics)
  dirs  = steepest_dir_codes(peak, fg, self_sticky=seeds)
  v0    = +lin+1 at seeded roots, -(lin+1) at unseeded roots, 0 elsewhere
  v     = h0 lockstep chase steps of V[x] <- V[x + offset(dirs[x])]
          (on the card one hop-walk launch, see ``ops/resolve.py``)

and returns ``(dirs, v)``, the state ``resolve.chase_resolve`` continues
from. A CUDA tensor runs the hand-written kernels of ``csrc/seed.cu`` (any
shape: no block guard, no fallback) or raises; a CPU tensor runs
:func:`seed_chase_pass_plain`, the unfused composition above.

On the card the body follows ``ops.peaks.nms_body(radius)``, decided before
any launch. ``"tile"`` (every per-axis radius 0..4): one tile pass that
keeps everything between the peak map and the seeds in shared memory and
registers and takes the ascent step where a seed is decided, then the walk; it allocates ``dirs``, ``v`` and
one int32 scratch volume (``v0``). ``"chain"`` (larger radii): up to seven
whole-volume pooling launches, the direction launch and the walk, through
five scratch volumes. ``seed_chase_pass.launches`` counts calls that
launched either, ``seed_chase_pass.tile_launches`` those of the tile pass.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops.neighbors import linear_index
from tpuseg_torch.ops.peaks import nms_body, peak_nms, radius3
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
                    radius=(2, 2, 2), h0: int = 8, body: str | None = None):
    """``(dirs, v)``: int32 direction codes and chase payloads after ``h0``
    lockstep chase steps. Both maps are taken as float32 (the TPU kernel's
    cast point); the thresholds are float32 scalars, each a float or a 0-d
    tensor, and on the card the kernels read them from device memory (the
    reference's traced scalars), so a threshold computed on the device is
    never read by the host.

    ``body`` is a hook for the card's checks and timings: ``body="chain"``
    runs the chain at a radius the rule gives to the tile pass. It is not
    reachable from a config."""
    if peak_prob.device.type == "cpu":
        return seed_chase_pass_plain(peak_prob, fg_prob, peak_threshold,
                                     fg_threshold, radius, h0)
    rz, ry, rx = radius3(radius)
    peak = peak_prob.to(torch.float32).contiguous()
    fgp = fg_prob.to(torch.float32).contiguous()
    _build.check_volume(peak, fgp)
    rule = nms_body((rz, ry, rx), smem_optin=_build.smem_optin())
    if body not in (None, "chain", rule):
        raise ValueError(f"radius {(rz, ry, rx)} takes the {rule} body, "
                         f"not {body!r}")
    body = body or rule

    def ivol():
        return torch.empty(peak.shape, dtype=torch.int32, device=peak.device)

    d, h, w = peak.shape
    lib = _build.load()
    dirs, v = ivol(), ivol()
    thrs = _build.device_scalars(peak_threshold, fg_threshold,
                                 device=peak.device)
    if body == "tile":
        v0 = ivol()
        err = lib.tpuseg_seed_chase(
            peak.data_ptr(), fgp.data_ptr(), thrs.data_ptr(), rz, ry, rx, h0,
            d, h, w, v0.data_ptr(), dirs.data_ptr(), v.data_ptr(),
            _build.stream_ptr())
    else:
        f0, f1 = torch.empty_like(peak), torch.empty_like(peak)
        cidx, i0, i1 = ivol(), ivol(), ivol()
        err = lib.tpuseg_seed_chase_chain(
            peak.data_ptr(), fgp.data_ptr(), thrs.data_ptr(), rz, ry, rx, h0,
            d, h, w,
            f0.data_ptr(), f1.data_ptr(), cidx.data_ptr(), i0.data_ptr(),
            i1.data_ptr(), dirs.data_ptr(), v.data_ptr(), _build.stream_ptr())
    _build.check(err, f"seed_chase_pass ({body})")
    seed_chase_pass.launches += 1
    seed_chase_pass.tile_launches += body == "tile"
    return dirs, v


seed_chase_pass.launches = 0
seed_chase_pass.tile_launches = 0
