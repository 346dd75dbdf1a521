"""Smoke run of the PyTorch/CUDA port (``tpuseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card: name, count, power limit (CUDA missing -> error);
2. build the hand-written kernels (K1 seed, K2 chase, K3 flood, K4 fused
   eval ConvBlock, K5 peak NMS, K6 training conv, the histograms H1-H3
   of one-volume inference, the union-find closure U1 and the saddle
   merge's pair-table kernels M1/M2) from
   ``tpuseg_torch/csrc`` and print nvcc's per-kernel register report;
3. each kernel against its plain PyTorch twin on the card, elementwise, at
   the main-path shape 96x512x512 (analytic maps of a 600-instance
   synthetic stack) and at a ragged shape; at both shapes also single
   ``chase_pass`` / ``flood_pass`` calls of 1, 3, 8 and 11 steps on random
   int32 payloads, random codes 0..6 (many point out of the volume) and
   random labels of either sign over a four-level potential (plateaus), a
   chase capped at 2 passes and floods capped at 13 and 96 steps; K1 (dirs
   and v both) on the inputs a tile pass can get wrong
   (``tpuseg_torch/ops/nms_cases.py``: a constant map, plateaus across every
   tile edge with the foreground cutting through them, values at the
   threshold exactly) at 96x512x512, at a shape one more than a multiple of
   the tile and at one below a tile, under per-axis radii 0..4 in mixed
   triples (the tile pass) and above 4 (the chain of whole-volume launches);
   kernel and twin times (CUDA events, after a warm-up) at 96x512x512, per
   pass of 8 steps and per resolve, K1 beside the chain it replaced, all
   beside the figures of the earlier designs;
4. the main path through its entry point: ``tpuseg_torch.cli.infer.main`` on
   a 96x512x512 volume with seeded weights of the full default U-Net
   (32/64/128/256, head 32, bf16) under the default InferConfig; every
   kernel's launch counter must be above 0 after the run, K1's by the tile
   pass, and H1-H3 (normalization and size filter) too, with the chase's
   and flood's passes run beside those enqueued (the loops' gates); then,
   warm, the stage times and each stage's peak device memory,
   and its post-processing through the twins on the same
   logits: labels equal elementwise; then K1-K3 against their twins on
   those seeded-weights probabilities (the main path's load: tens of chase
   passes, ten flood passes), with times per resolve;
5. the analytic-net pipeline on the same stack, once through the kernels and
   once through the twins: labels equal elementwise; F1@IoU0.5 against the
   ground truth;
6. K6 forward and dx against ``F.conv3d`` at the training shapes
   (8, ci, 64^3), ci in {1, 32, 64}, and at (3, ci, 13, 27, 45), in f32
   (TF32 off) and bf16, and in bf16 at two edge shapes of the tensor-core
   body (one plane narrower than a tile; every extent one more than a
   multiple of the tile); the wrapper's counters must show the tensor-core
   body for bf16 with ci >= 32 and the CUDA-core body otherwise; kernel and
   library times (bf16) at the full shapes, with TFLOP/s and their ratio;
7. the training main path through its entry point:
   ``tpuseg_torch.cli.train.main`` on the full default U-Net, batch 8 of
   64^3, ``train.apply_impl="fused"``, two synthetic volumes (one held out
   for validation with val-volume inference); K6 (its tensor-core body
   too) and K1-K3 launch counters above 0, finite losses, the checkpoint
   written, and a ``--resume`` run that continues from it; then one warm
   train step under the fused and the plain apply, in turns: wall time and
   device time by kernel (``torch.profiler``);
8. the fused and the plain-module train step on one fixed batch: loss and
   every parameter gradient (f32 and bf16 bounds in the phase);
9. bench.py's 200-step trained-weights recipe through
   ``tpuseg_torch.train.train`` (fused), then ``cli.infer`` with that
   checkpoint on the 96x512x512 stack, default, calibrated
   (``--calibrate-from``) and calibrated under
   ``infer.apply_impl="fused"``: the loss must halve and both calibrated
   F1@IoU0.5 reach 0.5;
10. K4 against its twin at the fused sweep's three block shapes
    (1, ci, 64, 160, 160), ci in {1, 64, 32}, at (2, ci, 5, 27, 45), at one
    plane and at 37 planes of 13 x 70 (more than one z chunk), in f32 (TF32
    off) and bf16, with non-zero seeded affines; bf16 must launch the
    tensor-core kernel and f32 the CUDA-core one; times (bf16) of the
    kernel, the twin and the library call (the module ``ConvBlock`` in eval
    mode: cuDNN convs + BatchNorm + ReLU), with TFLOP/s and their ratio;
11. K5 against its twin, elementwise, at 96x512x512 (radius 2) and at
    45x203x301 (radius (1, 2, 2), once more on a quantized map full of
    plateaus, and with radius 0 on z), each once more through the chain,
    and on the adversarial inputs and radii of phase 3; times of the kernel
    (one tile pass), the chain it replaced, the twin and a ``F.max_pool3d``
    NMS without the index tie-break (timing only);
12. the fused main path: ``cli.infer`` with ``infer.apply_impl="fused"`` on
    the stack and checkpoint of phase 4: K4 launched 3 x 48 = 144 times,
    all by the tensor-core kernel, K1-K3 above 0; warm stage times beside the plain sweep's, and each
    call's device time by kernel (``torch.profiler``); the fused logits
    against the same apply through K4's twin; then
    ``postproc.nms_impl="pallas"`` (K5 launched, labels elementwise equal
    to phase 4's) and ``postproc.method="flood"`` against its plain run,
    and the warm post-processing time of each composition; last, the
    kernel launches K1, K5 and one pass of 8 steps of K2 and K3 make
    (``torch.profiler``: one tile-pass launch and one walk launch for K1,
    one tile-pass launch for K5, none of the chain's kernels, one walk
    launch for a chase pass, at most two for a flood pass);
13. (run after phase 9, with its checkpoint) ``cli.infer`` on the stack
    under the two inference configurations of the JAX package's
    ``bench.py``: one whole-volume float32 tile (96, 512, 512) with no halo,
    and bf16 tiles (96, 256, 512) with halo (0, 8, 0) through the fused
    apply with peak threshold 0.35, both calibrated: K4 launched 3 x 2
    times on the tensor cores in the second, K1-K3 above 0 and convergence
    reported in both, F1@IoU0.5 within 0.02 of phase 9's calibrated figure;
    wall time, Mvox/s, instances, F1 and peak device memory of each;
14. (run after phase 9, with its checkpoint) the streamed path on a
    360x1024x1024 stack of 9000 nuclei (four z-chunks of 96, the last 72;
    (360, 512, 512) with 2250 nuclei on a host with under 32 GB free),
    with the synthesis time and the host's free memory: (a) AnalyticNet in
    float32, ``stream_infer(chunk_z=96)`` at the default halo equal to the
    one-shot ``make_infer_fn`` elementwise under default post-processing,
    ``merge_saddle_ratio=0.8`` (M1 and M2 launched once a chunk) and
    ``nms_impl="pallas"`` (K5 launched); a run killed after chunk 1 and
    resumed into a memmap equal to the uninterrupted one; a uint16 source
    equal to its float32 values; (b) phase 9's trained U-Net through
    ``cli.infer --stream 96 --report-convergence --validate
    --calibrate-from`` with the fused apply
    beside the one-shot ``cli.infer`` with the same flags: wall time,
    Mvox/s, stage seconds, peak device memory, instances and F1@IoU0.5 of
    both (the streamed one at most 0.02 below), F1 between the two, chase
    and flood passes per chunk; validation must pass, K1-K3 launch at
    least once a chunk, K4 exactly 3 x tiles per extended chunk x chunks x
    2 times on the tensor cores; the same stream at the threshold pass 1b
    found, with the copies overlapped and in sequence, in turns (the labels
    equal the call's); then the first 180 planes stream the same way, and
    the stream's own peak device memory, and the whole call's with the
    validation by chunks, must be within 10% of the 360-plane stream's;
    (c) the first 180 planes calibrated from all the stack's nuclei (the
    input on which ``--validate`` first failed): the one-shot labels
    connected, streams at halo 32 and 56 with every chunk's watershed held
    against the twins (K1-K3 and K5 at the extended chunks' shapes), their
    validation printed and each label in more than one piece located
    against the seam and beside its one-shot instance;
15. (run after phase 9, with its checkpoint, and after phase 14, with its
    stack, where it ran) the sharded paths, every shard on ``cuda:0``:
    (a) AnalyticNet in float32 on the pre-normalized 96x512x512 stack,
    ``make_sharded_infer_fn`` on a z2 and a (2, 2) mesh equal to the
    one-shot ``make_infer_fn`` elementwise under default post-processing,
    ``fg_target_fraction`` calibration, merge 0.8 and
    ``nms_impl="pallas"``, the default and pallas calls equal to their
    ``plain=True`` runs (K1-K3 and K5 against their twins at every shard's
    extended slab), ``z_offset=3_000_000`` equal to 0, and a
    ``normalize=True`` leg on the raw stack (the percentile scalars beside
    the one-shot's, the label agreement); (b) phase 9's trained U-Net
    through ``cli.infer --shard z2,y2 --calibrate-from --validate`` with
    the fused apply beside the one-shot call: F1@IoU0.5 within 0.02 of
    phase 9's calibrated figure, K1 launched 4 times and K4 576 (3 x 48
    tiles x 4 shards, all on the tensor cores), wall time, peak device
    memory and the extended slabs' voxels over the cores'; (c)
    ``stream_infer(chunk_z=96)`` with the chunks split over 4 y-shards,
    AnalyticNet in float32 on phase 14's stack (else a 180x1024x1024 one),
    equal to the single-device stream at merge 0 and 0.8, then
    ``cli.infer --stream 96 --stream-shard 4`` once with phase 9's
    checkpoint;
16. (run after phase 9, with its checkpoint) the multi-process runtime,
    worker processes started by this script (``--worker``) under the
    ``TPUSEG_*`` environment, every one on ``cuda:0``; NCCL refuses two
    ranks on one device, so the two-process legs run gloo
    (``TPUSEG_DIST_BACKEND``): (a) 5 data-parallel steps of the flagship
    net (bf16, fused apply, batch 8 of 64^3 split 4 + 4): both ranks' states
    bitwise equal after each step, step 1 within 2.5 lr of the
    single-process step on the same 8 examples, each loss within 1% of the
    single-process one, K6 11 launches a rank a step, ms per step per rank
    beside the all-reduces' share; (b) ``cli.train`` as 2 processes, 10
    steps then ``--resume`` to 20: one writer, one checkpoint directory;
    (c) ``cli.infer --shard z2`` and (d) ``--stream 48 --stream-shard 2``
    (``nms_impl="pallas"``) as 2 processes with phase 9's checkpoint,
    calibrated, fused apply, ``--validate``: labels equal to the
    single-process call's elementwise, K1, K5 and K4 per process as the
    shards' tiles give them, wall time and peak device memory per process
    beside the single-process call's; (e) NCCL on a group of one: (a)'s DP
    step equal to the step without a group, bitwise, and ``--shard z2``
    equal to (c)'s single-process labels;
17. (run after phase 9, with its checkpoint) the evaluation surface on the
    five adversarial fixtures of the JAX package's bench.py c5 quality
    matrix (``synthesize_touching_volume``, 96x512x512, 150 touching pairs
    and 100 singles each: touch60_snr20, touch60_snr8, touch50_overlap,
    touch70_gradient, touch65_aniso035), each under bench.py's c3
    configuration (bf16, fused apply, tiles (96, 256, 512) + halo (0, 8,
    0), peak threshold 0.35) calibrated from its annotations: (a) each
    through ``make_infer_fn``, F1@IoU0.5, centre F1 and centre recall
    beside the JAX package's record (touch60_snr20 must reach F1@IoU0.5
    0.5); (b) the five through ``make_batched_infer_fn`` equal to
    ``make_infer_fn`` per volume elementwise, with the wall times of both;
    (e) ``cli.export`` of the checkpoint loaded back: equal labels; (g)
    ``cli.train`` 2 steps and ``cli.infer`` with ``model.norm="group"``,
    ``model.activation="gelu"`` (K1-K3 launched, K4 not); then, after the
    launch count is read, (c) K1-K3 against their twins on touch60_snr20's
    trained probabilities, its calibrated watershed against its plain run
    and ``seed_labels_from_peaks`` through K5 against the plain NMS; (d)
    ``python -m tpuseg_torch.cli.evaluate`` (IoU and centre criterion, two
    processes) on its labels and ground truth equal to the in-process
    ``instance_metrics`` + ``voxel_metrics``, and the card's F1 helpers
    (which phases 5, 9 and 13-17 score with) equal to both; (f)
    ``measure_rf_radius`` of the trained net on a 128^3 probe, in bf16 and
    with its weights in float32;
18. (run after phase 9, with its checkpoint, and after phase 17, with its
    fixtures, where it ran) one-volume inference as one device program:
    (a) H1 (``ops/hist.bin_counts``) against its twin elementwise under
    both bin rules (the normalization's on the 96x512x512 stack, whole and
    sampled 1:4; the calibration's on its seeded-weights fg map) and on a
    stack of 2**25 voxels, H2 (``percentiles``) bit-equal to its numpy twin
    on each of those counts (bins above 2**24 among them), H3
    (``label_counts``) equal to ``torch.bincount`` on the seeded-weights
    watershed's index labels, and each one's time beside its twin's, the
    library call's and its bound; (b) K1 and K5 with their thresholds as
    0-d device tensors equal to the same host floats and to the twins, on
    the seeded-weights maps and on touch60_snr20's calibrated maps; (c) the
    chase and the flood gated on the device equal to the twins' host-read
    loops with as many passes run and the same gates, on the seeded
    weights (23 chase passes) and at the 128-pass cap (a c5 fixture under
    calibrated c3 where one reaches it, else a constant peak map whose
    chains climb 1117 hops); (d) ``make_infer_fn`` on the stack (plain and
    fused apply with seeded weights, calibrated c3 with phase 9's) and
    ``make_batched_infer_fn`` on the five c5 fixtures, each call inside
    ``torch.cuda.set_sync_debug_mode("error")`` after one warm call: no
    PyTorch call may wait for the device, and the labels equal the twins'
    post-processing of the same sweep run outside the mode (the fused
    sweep's own twin rounds bf16 otherwise: phase 12); (e) warm times: the
    batched call against five single calls (host enqueue and wall), the
    main-path calls of (d), and the seeded-weights resolves gated on the
    device against the same pass kernels in a host-read loop, with the
    chase's idle pass (128 idle passes against 2).

19. (run after phase 9, with its checkpoint) the saddle merge, the
    diagnostics and the sharded path with no host read: (a) U1
    (``ops/closure.union_closure``) against its twin elementwise on the
    saddle-merge edges of the seeded-weights stack (merge 0.8), random
    graphs of 10^3-10^6 edges, a 2^20-long path in bit-reversed order, a
    star of 2^20 leaves and a table of sentinels only, each timed beside
    the twin and its bound; (b) ``make_infer_fn`` with merge 0.8 and
    ``with_diagnostics=True`` on the stack (fused apply, seeded weights)
    and calibrated c3 (phase 9's net) inside
    ``torch.cuda.set_sync_debug_mode("error")`` after one warm call:
    labels, the truncation count and the merge's dropped counts equal the
    ``plain=True`` post-processing of the same sweep, one U1 launch a
    call, and M1 and M2 (``ops.merge.pair_aggregate`` / ``pair_slots``)
    once each; (c) ``make_sharded_infer_fn``'s ``infer(shards)`` inside
    the mode, shards on ``cuda:0``, meshes z2,y2 and z2, calibrated or
    not, merge 0 or 0.8: AnalyticNet in float32 equal to the one-shot
    labels (as [15a] holds them) and to ``plain=True`` (every twin, M1/M2's
    too), phase 9's net under c3 (module apply) equal to ``plain=True``,
    U1 launched once a call and once more with the merge, M1 and M2 once a
    shard with the merge; a z2 call with ``shard_max_labels=8`` prints
    its overflow after the labels, in the reference's words; (d) warm
    times: the post stage with the merge off and at 0.8 on the same
    logits, with each one's peak device memory above the logits; the
    merge at 0.8 on (b)'s inputs in its parts (edges: M1 + M2, closure:
    U1, apply), the edges through the twin's whole-volume sorts, and the
    whole merge's peak memory through each; and calibrated c3's one-shot
    call beside its ``--shard z2,y2`` call (host enqueue and wall); (e)
    M1 + M2 against their twin elementwise (``lo``, ``hi``, ``dropped``)
    at merge 0.8, merged labels against ``plain=True``'s, on the analytic
    maps' watershed, (b)'s merge inputs (seeded weights, calibrated c3),
    the seeded weights at ``max_pairs`` 64 (every axis past its buffer:
    the gated select route), a shard's grown core (a view, not contiguous)
    and a 160x1024x1024 extended chunk, with each kernel's time beside the
    twin's and its bound.

``--phases 3,11`` runs phases 1-2 and only the named ones (to try a kernel
alone; no final record; 12 brings 4 with it, 13-19 bring 9). Without
arguments every phase runs; the second-to-last lines are then the kernels'
JSON record (with each kernel's launches on the main path, on the streamed
path of phase 14, on the sharded paths of phase 15, in the worker
processes of phase 16 and on the touching fixtures of phase 17 (U1's, M1's
and M2's: on the merge-on and sharded calls of phase 19 (b) and (c)), K2's and
K3's passes run on the main path beside their launches, and its bound:
the
larger of its bytes over the card's memory rate and its operations over
the card's peak rate, from this run's shapes) and
nvidia-smi's ``name, power.limit``; the last line is
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
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
# edges of K6's tensor-core body: D = 1 with W < 8, and D, H, W each one more
# than a multiple of its tile (z chunk 16, 8 rows, 16 or 32 columns)
EDGE_CONV_SHAPES = ((1, 1, 3, 5), (2, 17, 9, 33))
BLOCK_SHAPE = (1, 64, 160, 160)         # one tile block of the default sweep
RAGGED_BLOCK_SHAPE = (2, 5, 27, 45)
# edges of K4: one plane; more than one z chunk (16 planes), not a multiple,
# with ragged rows and columns
EDGE_BLOCK_SHAPES = ((1, 1, 9, 20), (1, 37, 13, 70))
BLOCK_CI = (1, 64, 32)                  # enc0, up0.block, head_trunk
N_TILES = 48                            # blocks per 96x512x512 stack
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
    "fused_convblock": ("tpuseg_torch/csrc/convblock.cu",
                        "tpuseg/ops/pallas_convblock.py:382"),
    "fused_peak_nms": ("tpuseg_torch/csrc/nms.cu",
                       "tpuseg/ops/pallas_nms.py:133"),
    # H1-H3 have no Pallas counterpart: the reference's XLA code they stand
    # for (its histogram, its float32 CDF and search, its label histogram)
    "bin_counts": ("tpuseg_torch/csrc/hist.cu",
                   "tpuseg/data/normalize.py:55"),
    "percentiles": ("tpuseg_torch/csrc/hist.cu",
                    "tpuseg/data/normalize.py:59"),
    "label_counts": ("tpuseg_torch/csrc/hist.cu",
                     "tpuseg/ops/filter.py:130"),
    # U1 neither: the reference's XLA closure (hook and jump rounds)
    "union_closure": ("tpuseg_torch/csrc/closure.cu",
                      "tpuseg/parallel/reconcile.py:41"),
    # nor M1/M2: the reference's XLA pair table (per-axis sorts of every
    # face's pair key, compacted into max_pairs slots)
    "pair_aggregate": ("tpuseg_torch/csrc/pairs.cu",
                       "tpuseg/ops/merge.py:57"),
    "pair_slots": ("tpuseg_torch/csrc/pairs.cu", "tpuseg/ops/merge.py:57"),
}
# the saddle merge's pair-table kernels (ops/merge.py), launched once each
# by every merge-on call, once each a shard by a sharded one
PAIR_KERNELS = ("pair_aggregate", "pair_slots")
# the histogram kernels (ops/hist.py), launched by every one-volume call:
# H1 and H2 normalize, H3 counts the labels for the size filter
HIST_KERNELS = ("bin_counts", "percentiles", "label_counts")
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory rate, bf16 tensor-core rate, and the float32 rate outside the
# tensor cores, which also stands in for compare/select work.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INFER_KERNELS = ("seed_chase_pass", "chase_pass", "flood_pass")
PASS_ITERS = (1, 3, 8, 11)              # single passes held against the twins
# The designs these kernels had before (PERF.md; NVIDIA H100 80GB HBM3,
# 700.00 W, 96x512x512), printed beside the new times: K2 and K3 with one
# launch per step, K1 and K5 as a chain of whole-volume launches (which is
# still their body for radii above 4 and is timed again in this run).
EARLIER = {
    "seed_chase_pass": "the chain of whole-volume launches 1.189 ms on the "
                       "analytic maps, 1.609 ms on seeded weights; before "
                       "that, with 8 chase-step launches, 2.131 ms",
    "fused_peak_nms": "the chain of whole-volume launches 1.003 ms",
    "chase_pass": "~0.156 ms a step, ~1.25 ms a pass of 8; resolve 1.328 ms "
                  "on the analytic maps (1 pass), ~28.7 ms on seeded weights "
                  "(23 passes)",
    "flood_pass": "~0.27 ms a step, ~2.2 ms a pass of 8; resolve 3.628 ms on "
                  "the analytic maps (3 passes), ~21.8 ms on seeded weights "
                  "(10 passes)",
}
# the resolve kernels by their names in a profile: the launches one pass of
# 8 steps may make (K1's own chase steps are one chase_walk_kernel)
PASS_LAUNCHES = {"chase_pass_kernel": 1, "flood_march_kernel": 2}
WALK_KERNEL = "chase_walk_kernel"
# K1's and K5's kernels by name: the tile pass (one launch a call) and the
# chain's, which a call at radius 2 must not launch
TILE_KERNEL = "nms_tile_kernel"
CHAIN_KERNELS = ("maxpool_axis_kernel", "candidate_index_kernel",
                 "seed_dirs_kernel", "seed_mask_kernel")
TRAIN_KERNELS = INFER_KERNELS + ("conv3x3_raw",)   # validation infers
TRAIN_STEPS, RESUME_STEPS = 20, 24       # the train main path, then a resume
QUALITY_STEPS = 200                      # bench.py's trained-weights recipe
# the streamed path: four z-chunks of 96 (the last 72) at the main stack's
# nucleus density; a host with less free memory takes the cut
STREAM_SHAPE, STREAM_INSTANCES = (360, 1024, 1024), 9000
STREAM_CUT, STREAM_CUT_INSTANCES = (360, 512, 512), 2250
STREAM_MIN_FREE_GB = 32
STREAM_CHUNK = 96
STREAM_KERNELS = INFER_KERNELS + ("fused_convblock", "fused_peak_nms")
SHARDED_KERNELS = STREAM_KERNELS        # K1-K5: phase 15's sharded runs
MP_DP_STEPS = 5                         # phase 16: DP steps of (a)
MP_DP_NORM_RTOL = 5e-3                  # (a) step 1: gradient norm, bf16
MP_DP_GRAD_RTOL = 1e-3                  # (a) step 1 in f32: gradient, L2
MP_STREAM_CHUNK = 48                    # phase 16 (d): two chunks of the stack
# phase 17: bench.py's c5 quality matrix (bench.py:346-402) on the port: the
# five adversarial fixtures, each scored under bench.py's c3 configuration
# (bench.py:323-328) calibrated from its own annotations
C5_KW = dict(shape=MAIN_SHAPE, num_pairs=150, num_singles=100,
             radius_range=(5.0, 8.0), seed=17)
C5_FIXTURES = {
    "touch60_snr20": dict(touch_factor=0.6, noise=0.05),
    "touch60_snr8": dict(touch_factor=0.6, noise=0.12),
    "touch50_overlap": dict(touch_factor=0.5, noise=0.05),
    "touch70_gradient": dict(touch_factor=0.7, noise=0.05, gradient=0.3),
    "touch65_aniso035": dict(touch_factor=0.65, noise=0.05,
                             anisotropy=(0.35, 1.0, 1.0)),
}
C3_SETS = {"infer.tile": [96, 256, 512], "infer.halo": [0, 8, 0],
           "infer.apply_impl": "fused", "postproc.peak_threshold": 0.35}
# the JAX package's record of the same cells on a TPU (BENCH_r05.json):
# F1@IoU0.5, f1_center, recall_center (recorded for the aniso leg only)
C5_JAX = {"touch60_snr20": (0.98, 0.9975, None),
          "touch60_snr8": (0.9876, 0.9925, None),
          "touch50_overlap": (0.9463, 0.9888, None),
          "touch70_gradient": (0.9702, 0.9926, None),
          "touch65_aniso035": (0.8801, 0.9541, 0.935)}
TOUCHING_KERNELS = INFER_KERNELS + ("fused_convblock",)
# phase 19: U1 on the merge edges at merge 0.8 (phase 14's and 15's ratio),
# on random graphs of 10^3-10^6 edges, a 2^20-long path and a star
U1_MERGE_RATIO = 0.8
U1_RANDOM_EDGES = (10 ** 3, 10 ** 4, 10 ** 5, 10 ** 6)
U1_PATH_BITS = 20
# phase 19 (e): M1/M2 at a max_pairs whose buffer (2 x max_pairs) every axis
# of the stack overflows (the gated select route), and on one extended
# chunk of the stream (160 planes: a 96-plane chunk, halo 32 each side)
PAIR_TINY_MAX_PAIRS = 64
PAIR_CHUNK_SHAPE = (160, 1024, 1024)
SENT32 = 2 ** 31 - 1                    # an unused slot of the int32 tables
RF_PROBE = 128                          # > 2 x the 4-level net's radius (~53)
VARIANT_STEPS = 2                       # (g): cli.train steps of the variant


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


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def kernel_launch_counts(fn, complete=None, attempts: int = 4) -> dict:
    """Launches by kernel name during one ``fn()`` (``torch.profiler``). A
    trace often comes back without its first device events, or without any
    when it holds only two or three kernels: so a few throwaway launches
    open each trace, and one that ``complete(counts)`` finds short is
    taken again. Returns the last trace; empty where the profiler saw no
    device activity in any attempt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    scratch = torch.zeros(1 << 20, device="cuda")
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                scratch.add_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        if counts and (complete is None or complete(counts)):
            break
    return counts


def check_launches_per_pass(fg, pk, reps: int = 5) -> None:
    """The kernel launches of K1, of K5 and of a pass of 8 steps of K2 and K3
    on one pair of maps, from one ``torch.profiler`` trace over K1 and K5
    once and ``reps`` passes of each: K1 is one tile-pass launch and one
    walk launch, K5 one tile-pass launch, and neither launches a kernel of
    the chain; a chase pass is one launch of its own, the flood takes at
    most ``PASS_LAUNCHES`` of its own a pass. Run after
    everything that is timed on the host's clock:
    once the profiler has traced, every later launch of the process costs
    the host more."""
    from tpuseg_torch.ops.nms import fused_peak_nms
    from tpuseg_torch.ops.resolve import chase_pass, chase_resolve, flood_pass
    from tpuseg_torch.ops.seed import seed_chase_pass

    thr = 0.5
    fgm = fg >= thr
    dirs, v = seed_chase_pass(pk, fg, thr, thr, (2, 2, 2))
    pot = torch.where(fgm, fg.float(), float("-inf"))
    lab0 = torch.where(fgm, chase_resolve(v, dirs, fgm).clamp(min=0),
                       0).to(torch.int32)

    def calls():
        seed_chase_pass(pk, fg, thr, thr, (2, 2, 2))
        fused_peak_nms(pk, thr, (2, 2, 2))
        for _ in range(reps):
            chase_pass(v, dirs, fgm, 8)
            flood_pass(pot, lab0, 8)

    def named(counts, name):
        return sum(n for key, n in counts.items() if name in key)

    # a trace that lost events counts too few launches, never too many
    counts = kernel_launch_counts(calls, complete=lambda c: (
        named(c, TILE_KERNEL) >= 2 and named(c, WALK_KERNEL) >= 1
        and named(c, "chase_pass_kernel") >= reps
        and named(c, "flood_march_kernel") >= reps))
    if not counts:
        print("[12] kernel launches: not measured (no device trace)")
        return
    chases, floods = (named(counts, name) for name in PASS_LAUNCHES)
    walks = named(counts, WALK_KERNEL)
    most = PASS_LAUNCHES["flood_march_kernel"]
    tiles = named(counts, TILE_KERNEL)
    chain = {key: n for key, n in counts.items()
             if any(name in key for name in CHAIN_KERNELS)}
    if (walks != 1 or chases != reps or not reps <= floods <= most * reps
            or tiles != 2 or chain):
        raise AssertionError(
            f"K1, K5 and {reps} passes of 8 steps of K2 and K3 launched "
            f"{TILE_KERNEL} {tiles} times (expected 2: one for K1, one for "
            f"K5), the chain's kernels {chain} (expected none), "
            f"{WALK_KERNEL} {walks} times (expected 1), chase_pass_kernel "
            f"{chases} times (expected {reps}) and flood_march_kernel "
            f"{floods} times (expected {reps}...{most * reps}): {counts}")
    print(f"[12] kernel launches: K1 one {TILE_KERNEL} and one "
          f"{WALK_KERNEL}, K5 one {TILE_KERNEL}, none of the chain's; "
          f"{reps} chase passes of 8 steps {chases} x chase_pass_kernel "
          f"(one each), {reps} flood passes of 8 steps {floods} x "
          f"flood_march_kernel (at most {most} each)")


def compare_kernels(fg, pk, timed: bool):
    """K1-K3 against their twins on one pair of maps; returns per kernel a
    record with max_abs_err and, if timed: for K1 ms, plain_ms and the bound
    of the call; for K2 and K3 those of one pass of 8 steps from the state
    the resolve starts in, and resolve_ms, resolve_plain_ms, passes (run:
    read from the loop's gates, equal to the twin's host loop's),
    passes_enqueued and resolve_bound_ms of the whole ``chase_resolve`` /
    ``flood_resolve``.

    Bounds, per voxel: K1 reads two float32 maps and writes two int32
    volumes (16 B) for about 60 compare/select operations (two separable
    5-wide pools, the 6-neighbour argmax, 8 chase steps). A K2 pass must
    read values, dirs and the mask and write values (13 B); a K3 pass must
    read the potential and the labels and write the labels (12 B), each
    for about 8 x 10 operations; the resolve loops are data dependent, so
    their bound counts the passes this input ran. No single library call
    computes any of the three."""
    from tpuseg_torch.ops.resolve import (chase_pass, chase_pass_plain,
                                          chase_resolve, chase_resolve_plain,
                                          flood_pass, flood_pass_plain,
                                          flood_resolve, flood_resolve_plain,
                                          passes_run)
    from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

    thr, radius, flood_iters = 0.5, (2, 2, 2), 96
    loops = {"chase_pass": (chase_resolve, chase_resolve_plain),
             "flood_pass": (flood_resolve, flood_resolve_plain)}
    fgm = fg >= thr
    runs = {
        "seed_chase_pass": (
            seed_chase_pass, 16, 60,
            lambda: seed_chase_pass(pk, fg, thr, thr, radius),
            lambda: seed_chase_pass_plain(pk, fg, thr, thr, radius)),
    }
    dirs, v = seed_chase_pass_plain(pk, fg, thr, thr, radius)
    runs["chase_pass"] = (chase_pass, 13, 80,
                          lambda: chase_resolve(v, dirs, fgm),
                          lambda: chase_resolve_plain(v, dirs, fgm))
    v_res = chase_resolve_plain(v, dirs, fgm).clamp(min=0)
    runs["flood_pass"] = (
        flood_pass, 12, 80,
        lambda: flood_resolve(v_res, fgm, fg, flood_iters),
        lambda: flood_resolve_plain(v_res, fgm, fg, flood_iters))
    # one pass of 8 from where each resolve starts
    pot = torch.where(fgm, fg.float(), float("-inf"))
    lab0 = torch.where(fgm, v_res, 0).to(torch.int32)
    one_pass = {
        "chase_pass": (lambda: chase_pass(v, dirs, fgm, 8),
                       lambda: chase_pass_plain(v, dirs, fgm, 8)),
        "flood_pass": (lambda: flood_pass(pot, lab0, 8),
                       lambda: flood_pass_plain(pot, lab0, 8)),
    }
    out = {}
    for name, (wrapper, vox_bytes, vox_ops, kern, plain) in runs.items():
        before = wrapper.launches, getattr(wrapper, "tile_launches", None)
        got = kern()
        want = plain()
        passes = launched = wrapper.launches - before[0]
        if name in loops:
            # enqueued passes gate themselves off on the device: the gates
            # say how many ran, and the twin's host loop ran as many
            passes, ran_plain = (passes_run(f.last_gates)
                                 for f in loops[name])
            if passes != ran_plain:
                raise AssertionError(
                    f"{name}: the device loop ran {passes} passes, the "
                    f"twin's host loop {ran_plain}")
        if before[1] is not None and wrapper.tile_launches - before[1] != 1:
            raise AssertionError(f"{name}: radius {radius} did not take the "
                                 "tile pass")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err != 0:
            raise AssertionError(f"{name}: kernel != twin at {tuple(fg.shape)} "
                                 f"(max abs err {err})")
        out[name] = {"max_abs_err": err}
        if not timed:
            continue

        def call_bound(n):
            return bound(n * vox_bytes * fg.numel(), n * vox_ops * fg.numel(),
                         F32_FLOPS)

        if name in one_pass:
            out[name].update(
                ms=cuda_ms(one_pass[name][0], 10),
                plain_ms=cuda_ms(one_pass[name][1], 2), library_ms=None,
                **call_bound(1), passes=passes, passes_enqueued=launched,
                resolve_ms=cuda_ms(kern, 5),
                resolve_plain_ms=cuda_ms(plain, 2),
                resolve_bound_ms=call_bound(passes)["bound_ms"])
        else:
            # K1: the tile pass, and beside it the chain it replaced (still
            # the body for radii above 4), through the wrapper's hook
            chain = seed_chase_pass(pk, fg, thr, thr, radius, body="chain")
            if any(not torch.equal(a, b) for a, b in zip(chain, want)):
                raise AssertionError(f"{name}: chain body != twin at "
                                     f"{tuple(fg.shape)}")
            out[name].update(
                ms=cuda_ms(kern, 10), plain_ms=cuda_ms(plain, 2),
                chain_ms=cuda_ms(lambda: seed_chase_pass(
                    pk, fg, thr, thr, radius, body="chain"), 10),
                library_ms=None, passes=passes, **call_bound(1))
    return out


def print_kernel_times(phase: str, load: str, recs: dict) -> None:
    """One line per kernel of a timed ``compare_kernels`` record."""
    for name, r in recs.items():
        line = (f"[{phase}] {name} on {load}: kernel {r['ms']:.3f} ms, twin "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
                f"{r['bound_by']}")
        if "resolve_ms" in r:
            line += (f" (one pass of 8); resolve {r['resolve_ms']:.3f} ms in "
                     f"{r['passes']} passes run of {r['passes_enqueued']} "
                     f"enqueued, twin {r['resolve_plain_ms']:.3f} ms, bound "
                     f"{r['resolve_bound_ms']:.3f} ms")
        if "chain_ms" in r:
            line += (f" (the tile pass and the walk); the chain in this run "
                     f"{r['chain_ms']:.3f} ms")
        print(f"{line}; earlier: {EARLIER[name]}")


def random_resolve_inputs(shape, seed: int):
    """Inputs no watershed would make, on the card: int32 payloads over the
    whole range (three in ten 0), codes 0..6 wherever they point, a mask;
    a potential of four levels with a quarter of the voxels at -inf, and
    labels of either sign on one voxel in fifty, off the foreground too."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand():
        return torch.rand(shape, device="cuda", generator=g)

    def randint(lo, hi):
        return torch.randint(lo, hi, shape, device="cuda", generator=g)

    values = torch.where(rand() < 0.3, 0, randint(-2**31, 2**31)).to(torch.int32)
    dirs = randint(0, 7).to(torch.int32)
    fgm = rand() < 0.6
    pot = torch.where(rand() < 0.25, float("-inf"), randint(0, 4) / 4.0).float()
    labels = torch.where(rand() < 0.02, randint(-5, 2**31), 0).to(torch.int32)
    return values, dirs, fgm, pot, labels


def compare_random_passes(shape) -> str:
    """Single passes of K2 and K3 at each of ``PASS_ITERS`` steps, and capped
    resolves, against the twins on ``random_resolve_inputs``: elementwise,
    and the unresolved count and the changed flag with them."""
    from tpuseg_torch.ops.resolve import (chase_pass, chase_pass_plain,
                                          chase_resolve, chase_resolve_plain,
                                          flood_pass, flood_pass_plain,
                                          flood_resolve, flood_resolve_plain)

    values, dirs, fgm, pot, labels = random_resolve_inputs(shape, SEED + 2)

    def same(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what} at {tuple(shape)}: kernel != twin "
                                 f"on {int((got != want).sum())} voxels")

    moved = []
    for iters in PASS_ITERS:
        (got, n), (want, n_want) = (f(values, dirs, fgm, iters)
                                    for f in (chase_pass, chase_pass_plain))
        same(f"chase_pass({iters})", got, want)
        if int(n) != int(n_want):
            raise AssertionError(f"chase_pass({iters}): unresolved {int(n)} "
                                 f"!= twin's {int(n_want)}")
        (got, ch), (want, ch_want) = (f(pot, labels, iters)
                                      for f in (flood_pass, flood_pass_plain))
        same(f"flood_pass({iters})", got, want)
        if bool(ch) != bool(ch_want):
            raise AssertionError(f"flood_pass({iters}): changed {bool(ch)} "
                                 f"!= twin's {bool(ch_want)}")
        moved.append(int((got != labels).sum()))
    same("chase_resolve(max_passes=2)",
         chase_resolve(values, dirs, fgm, max_passes=2),
         chase_resolve_plain(values, dirs, fgm, max_passes=2))
    fg_of_pot = pot > float("-inf")
    for max_iters in (13, 96):
        same(f"flood_resolve(max_iters={max_iters})",
             flood_resolve(labels, fg_of_pot, pot, max_iters),
             flood_resolve_plain(labels, fg_of_pot, pot, max_iters))
    # a flood with nothing left to take must report no change
    done = flood_resolve_plain(labels, fg_of_pot, pot, 10_000)
    got, ch = flood_pass(pot, torch.where(fg_of_pot, done, 0), 8)
    same("flood_pass at the fixed point", got, torch.where(fg_of_pot, done, 0))
    if bool(ch):
        raise AssertionError("flood_pass reports a change at the fixed point")
    return (f"{tuple(shape)}: chase_pass and flood_pass at {PASS_ITERS} steps, "
            f"chase_resolve(max_passes=2), flood_resolve(max_iters=13 and 96) "
            f"and a flood pass at its fixed point == twins (flood passes "
            f"labelled {moved} voxels)")


def compare_tile_cases(kernel: str) -> str:
    """K1 (``kernel="seed"``: dirs and v both) or K5 (``"nms"``: the mask)
    against the plain twin on the inputs a tile pass can get wrong
    (``tpuseg_torch/ops/nms_cases.py``): a constant map (its seeds are known
    in closed form), maps of plateaus across every tile edge with the
    foreground cutting through them, values at the threshold exactly; at
    the main-path shape (radius 2 and a mixed triple), at a shape one more
    than a multiple of the tile with two z chunks, and at a shape below one
    tile with rz >= D; every per-axis radius in ``TILE_RADII`` must take the
    tile pass, and those of ``CHAIN_RADII`` the chain, and still equal the
    twin. Also holds the rule's numbers to the library's."""
    from tpuseg_torch.ops import _build
    from tpuseg_torch.ops.nms import fused_peak_nms, fused_peak_nms_plain
    from tpuseg_torch.ops.nms_cases import (CHAIN_RADII, EDGE_SHAPE,
                                            SMALL_SHAPE, THRESHOLD, TILE_RADII,
                                            adversarial_maps,
                                            expected_constant_seeds)
    from tpuseg_torch.ops.peaks import (TILE_MAX_RADIUS, nms_body,
                                        nms_tile_smem_bytes)
    from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

    lib, optin = _build.load(), _build.smem_optin()
    dirs = kernel == "seed"
    if lib.tpuseg_nms_tile_max_radius() != TILE_MAX_RADIUS:
        raise AssertionError("the rule's radius limit is not the library's")
    for r in TILE_RADII:
        need = nms_tile_smem_bytes(r)
        if lib.tpuseg_nms_tile_smem(r[1], r[2]) != need \
                or need > optin or nms_body(r, optin) != "tile":
            raise AssertionError(f"radius {r}: the rule computes {need} B of "
                                 f"shared memory (opt-in limit {optin} B)")
    wrapper = seed_chase_pass if dirs else fused_peak_nms
    n_cases = 0
    for shape, radii in ((MAIN_SHAPE, ((2, 2, 2), (3, 1, 4))),
                         (EDGE_SHAPE, TILE_RADII + CHAIN_RADII),
                         (SMALL_SHAPE, TILE_RADII + CHAIN_RADII)):
        for name, peak, fgp in adversarial_maps(shape, seed=SEED):
            pk = torch.from_numpy(peak).cuda()
            fg = torch.from_numpy(fgp).cuda()
            for radius in radii:
                tag = f"{wrapper.__name__} on the {name} map, {shape}, " \
                      f"radius {radius}"
                before = wrapper.tile_launches
                if dirs:
                    got = seed_chase_pass(pk, fg, THRESHOLD, 0.5, radius)
                    want = seed_chase_pass_plain(pk, fg, THRESHOLD, 0.5,
                                                 radius)
                else:
                    got = (fused_peak_nms(pk, THRESHOLD, radius),)
                    want = (fused_peak_nms_plain(pk, THRESHOLD, radius),)
                torch.cuda.synchronize()
                ran_tile = wrapper.tile_launches - before
                if ran_tile != int(radius in TILE_RADII):
                    raise AssertionError(f"{tag}: the tile pass launched "
                                         f"{ran_tile} times")
                for what, a, b in zip(("dirs", "v") if dirs else ("seeds",),
                                      got, want):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        raise AssertionError(
                            f"{tag}: {what}: kernel != twin on "
                            f"{int((a != b).sum())} voxels")
                if name == "constant" and not dirs:
                    known = expected_constant_seeds(shape, radius)
                    if not np.array_equal(got[0].cpu().numpy(), known):
                        raise AssertionError(f"{tag}: not the known seeds")
                n_cases += 1
    return (f"{wrapper.__name__} == twin in {n_cases} adversarial cases "
            f"(constant, quantized, blocks, at threshold; {MAIN_SHAPE}, "
            f"{EDGE_SHAPE}, {SMALL_SHAPE}); radii {TILE_RADII} took the tile "
            f"pass, {CHAIN_RADII} the chain")


def phase_kernels(image: np.ndarray):
    from tpuseg_torch.data import synthesize_volume

    fg, pk = analytic_maps(image, "cuda")
    main = compare_kernels(fg, pk, timed=True)
    ragged = synthesize_volume(shape=RAGGED_SHAPE, num_instances=40,
                               seed=SEED + 1).image
    rag = compare_kernels(*analytic_maps(ragged, "cuda"), timed=False)
    for name, r in main.items():
        r["max_abs_err"] = max(r["max_abs_err"], rag[name]["max_abs_err"])
    print(f"[3] K1-K3 == twins at {MAIN_SHAPE} and {RAGGED_SHAPE} on the "
          "analytic maps")
    print_kernel_times("3", f"the analytic maps, {MAIN_SHAPE}", main)
    for shape in (MAIN_SHAPE, RAGGED_SHAPE):
        print(f"[3] random inputs, {compare_random_passes(shape)}")
    print(f"[3] {compare_tile_cases('seed')}")
    return main


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
    train path's full-width shapes and a ragged one, and in bf16 at two edge
    shapes of the tensor-core body; which body ran (the wrapper's counters);
    kernel and twin times (bf16, CUDA events) at the full-width shapes."""
    from tpuseg_torch.ops.convtrain import (conv3x3_raw, conv3x3_raw_plain,
                                            conv_body, flip_w)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, times = 0.0, {}
    for shape in (TRAIN_SHAPE, RAGGED_CONV_SHAPE) + EDGE_CONV_SHAPES:
        n, sp = shape[0], shape[1:]
        edge = shape in EDGE_CONV_SHAPES
        for ci in ((32, 64) if edge else (1, 32, 64)):
            w32 = torch.randn((32, ci, 3, 3, 3), device="cuda", generator=g) \
                / (27 * ci) ** 0.5
            x32 = torch.randn((n, ci, *sp), device="cuda", generator=g)
            dy32 = torch.randn((n, 32, *sp), device="cuda", generator=g)
            for dtype in ((torch.bfloat16,) if edge
                          else (torch.float32, torch.bfloat16)):
                x, w, dy = x32.to(dtype), w32.to(dtype), dy32.to(dtype)
                wf = flip_w(w).contiguous()
                for what, (a, b) in {"fwd": (x, w), "dx": (dy, wf)}.items():
                    tag = f"conv3x3 {what} ci={ci} {tuple(shape)} {dtype}"
                    body = conv_body(dtype, b.shape[1], b.shape[0])
                    before = conv3x3_raw.mma_launches
                    got = conv3x3_raw(a, b)
                    want = conv3x3_raw_plain(a, b)
                    torch.cuda.synchronize()
                    ran_mma = conv3x3_raw.mma_launches - before
                    if ran_mma != int(dtype == torch.bfloat16 and ci >= 32):
                        raise AssertionError(
                            f"{tag}: tensor-core body launched {ran_mma} "
                            f"times (rule says {body})")
                    worst = max(worst, check_conv(tag, got, want, dtype))
                    if shape == TRAIN_SHAPE and dtype == torch.bfloat16:
                        times[(what, ci)] = (
                            cuda_ms(lambda: conv3x3_raw(a, b), 5),
                            cuda_ms(lambda: conv3x3_raw_plain(a, b), 5), body)
            del x32, dy32
    vox = int(np.prod(TRAIN_SHAPE))
    for (what, ci), (ms, plain_ms, body) in times.items():
        flop = 2 * 27 * 32 * ci * vox
        print(f"[6] conv3x3 {what} {ci if what == 'fwd' else 32}->"
              f"{32 if what == 'fwd' else ci} {TRAIN_SHAPE} bf16, body {body}:"
              f" kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s), "
              f"F.conv3d {plain_ms:.3f} ms, ratio {ms / plain_ms:.2f}")
    print(f"[6] conv3x3 == twin (fwd and dx, f32 and bf16) at {TRAIN_SHAPE} "
          f"and {RAGGED_CONV_SHAPE}, ci in (1, 32, 64), and in bf16 at "
          f"{EDGE_CONV_SHAPES}; the tensor-core body ran for bf16 with ci >= "
          f"32 and never for f32 or ci = 1; max abs err {worst:.3g}")
    # the record: fwd ci=32 in bf16. 2*27*32*32 FLOP per voxel on the tensor
    # cores' rate; x and y in bf16 plus the weights. The twin is the library
    # call (F.conv3d).
    ms, plain_ms, body = times[("fwd", 32)]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": plain_ms, "body": body,
            **bound(2 * 32 * vox * 2 + 27 * 32 * 32 * 2,
                    2 * 27 * 32 * 32 * vox, BF16_FLOPS)}


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _reset_launches():
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        for body in ("mma_launches", "tile_launches"):
            if hasattr(fn, body):
                setattr(fn, body, 0)


def _launches():
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def _mma_launches():
    """Launches of the tensor-core bodies (K4, K6) since the last reset."""
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    return {fn.__name__: fn.mma_launches for fn in KERNEL_WRAPPERS
            if hasattr(fn, "mma_launches")}


def _tile_launches():
    """Launches of the tile-pass bodies (K1, K5) since the last reset."""
    from tpuseg_torch.ops import KERNEL_WRAPPERS

    return {fn.__name__: fn.tile_launches for fn in KERNEL_WRAPPERS
            if hasattr(fn, "tile_launches")}


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
    with PassTally() as tally:
        status = cli_infer.main(["--checkpoint", ckpt, "--input", vol_path,
                                 "--output", out_path,
                                 "--report-convergence"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    tiles = _tile_launches()
    ran = dict(zip(("chase_pass", "flood_pass"), tally.passes()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[4] cli.infer exit status {status} "
          f"({'flood truncated' if status == 4 else 'converged'}); "
          f"kernel launches {launches}, by the tile pass {tiles}; passes "
          f"run of those enqueued: {ran}")
    if status not in (0, 4):
        raise AssertionError(f"cli.infer returned {status}")
    missing = [k for k in INFER_KERNELS + HIST_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if tiles["seed_chase_pass"] != launches["seed_chase_pass"]:
        raise AssertionError("main path: K1 did not take the tile pass")

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
    return launches, tiles, ran, ckpt, cfg, labels


def phase_warm_stages(image: np.ndarray, ckpt: str, cfg):
    """The same main path, warm, timed per stage; then its post-processing
    again through the plain twins on the same logits: labels must agree;
    then K1-K3 against their twins on the probabilities of those logits.
    Returns that comparison's record (``compare_kernels``)."""
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
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = stage_net(vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    net_peak = torch.cuda.max_memory_allocated()
    held_post = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    labels = stage_post(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    post_peak = torch.cuda.max_memory_allocated()
    vox = int(np.prod(MAIN_SHAPE))
    print(f"[4] warm: net sweep {1e3 * (t1 - t0):.1f} ms, post {1e3 * (t2 - t1):.1f}"
          f" ms, total {1e3 * (t2 - t0):.1f} ms ({vox / (t2 - t0) / 1e6:.2f} Mvox/s)")
    print(f"[4] warm peak device memory by stage (model and volume held: "
          f"{held / 1e6:.1f} MB): net sweep {net_peak / 1e6:.1f} MB; "
          f"post-processing {post_peak / 1e6:.1f} MB, of which "
          f"{(post_peak - held_post) / 1e6:.1f} MB its own (the logits and "
          f"what was held before it: {held_post / 1e6:.1f} MB)")
    for k, v in logits.items():
        if v.shape != MAIN_SHAPE or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: shape {tuple(v.shape)} or non-finite")
    post_stage_with_chain(stage_post, logits, labels)
    plain = make_infer_stages(model, cfg, plain=True)[2](logits)
    if not torch.equal(labels, plain):
        raise AssertionError(f"main path: kernels != twins on "
                             f"{int((labels != plain).sum())} voxels")
    print(f"[4] main-path post-processing: kernels == twins elementwise "
          f"({int(labels.max())} instances)")
    del labels, plain
    # K1-K3 one by one on this load, as phase 3 has them on the analytic maps
    seeded = compare_kernels(torch.sigmoid(logits["fg_logits"]).float(),
                             torch.sigmoid(logits["peak_logits"]).float(),
                             timed=True)
    print("[4] K1-K3 == twins on the seeded-weights probabilities")
    print_kernel_times("4", "the seeded-weights probabilities", seeded)
    return seeded


def post_stage_with_chain(stage_post, logits, labels) -> None:
    """The warm post-processing stage once more with K1 on the chain of
    whole-volume launches it had before (the seed module's body rule is
    answered with "chain" for the time of the call; no config reaches
    that), in turns with the tile pass: labels equal, time and the stage's
    own peak device memory of each."""
    import tpuseg_torch.ops.seed as seed_mod

    rule = seed_mod.nms_body
    held = torch.cuda.memory_allocated()
    runs = {"tile pass": [], "chain": []}
    try:
        for body in ("chain", "tile pass", "tile pass", "chain"):
            seed_mod.nms_body = ((lambda *a, **k: "chain") if body == "chain"
                                 else rule)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = stage_post(logits)
            torch.cuda.synchronize()
            runs[body].append((1e3 * (time.perf_counter() - t0),
                               (torch.cuda.max_memory_allocated() - held) / 1e6))
            if not torch.equal(got, labels):
                raise AssertionError(f"post-processing with K1 on the {body}: "
                                     "other labels")
            del got
    finally:
        seed_mod.nms_body = rule
    print("[4] warm post-processing with K1 on the tile pass / on the chain, "
          "two turns each: "
          + "; ".join(f"{body}: {' / '.join(f'{ms:.1f}' for ms, _ in r)} ms, "
                      f"the stage's own peak device memory "
                      f"{' / '.join(f'{mb:.1f}' for _, mb in r)} MB"
                      for body, r in runs.items()))


def phase_analytic(sv):
    from tpuseg_torch.core import Config, InferConfig
    from tpuseg_torch.infer import make_infer_stages

    cfg = Config(infer=InferConfig(compute_dtype="float32"))
    vol = torch.from_numpy(sv.image).cuda()
    got = make_infer_stages(AnalyticNet(), cfg)[0](vol).cpu().numpy()
    want = make_infer_stages(AnalyticNet(), cfg, plain=True)[0](vol).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"analytic pipeline: kernels != twins on "
                             f"{int((got != want).sum())} voxels")
    m = f1_iou50_on_card(got, sv.labels)
    c = center_f1_on_card(got, sv.labels)
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
    launches_mma = _mma_launches()["conv3x3_raw"]
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
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
          f"kernel launches {launches}, {launches_mma} of K6's by the "
          f"tensor-core body")
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
    if launches_mma == 0:
        raise AssertionError("train main path never launched K6's "
                             "tensor-core body")
    phase_train_step_times()
    return launches


def phase_train_step_times():
    """One warm train step (full default U-Net, batch 8 of 64^3, bf16) under
    the fused and the plain-module apply, in turns on one fixed batch: wall
    ms ending in a synchronize, then each step's device time by kernel."""
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import PatchSampler, synthesize_volume
    from tpuseg_torch.models import build_model
    from tpuseg_torch.train.step import create_train_state, make_train_step

    vol = synthesize_volume(shape=(64, 128, 128), num_instances=16, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in PatchSampler(
        [vol], batch_size=TRAIN_SHAPE[0]).next_batch().items()}
    steps = {}
    for tag, impl in (("fused", "fused"), ("plain", "flax")):
        cfg = Config().override(**{"train.apply_impl": impl})
        model = build_model(cfg.model, seed=SEED).cuda().train()
        state = create_train_state(model, cfg)
        step_fn = make_train_step(model, cfg)
        steps[tag] = lambda state=state, step_fn=step_fn: step_fn(
            state, batch, SEED + 1)
        for _ in range(2):
            steps[tag]()
    times = {"fused": [], "plain": []}
    # the first turn of each is a warm-up of the alternation itself (the
    # allocator's cache is shared by the two models) and is not kept
    for turn, tag in enumerate(("plain", "fused", "plain", "fused", "fused",
                                "plain")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            steps[tag]()
        torch.cuda.synchronize()
        if turn >= 2:
            times[tag].append(1e3 * (time.perf_counter() - t0) / 5)
    print(f"[7] warm train step, mean of 5, two turns each: fused apply "
          f"{' / '.join(f'{t:.1f}' for t in times['fused'])} ms, plain "
          f"apply {' / '.join(f'{t:.1f}' for t in times['plain'])} ms")
    for tag in ("fused", "plain"):
        profile_device_time(f"one warm {tag} train step", steps[tag], phase=7)


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
    inflation, as bench.py's c3 does), the latter once more with
    ``infer.apply_impl="fused"`` (K4). Both calibrated F1@IoU0.5 must
    reach 0.5; the default one is printed."""
    from tpuseg_torch.cli import infer as cli_infer
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import save_annotations, synthesize_volume
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
    for tag, extra in (
            ("default", []),
            ("calibrated", ["--calibrate-from", ann_path]),
            ("calibrated, fused apply",
             ["--calibrate-from", ann_path, "--set",
              'infer.apply_impl="fused"'])):
        out_path = os.path.join(tmp, f"labels_{len(f1)}.npy")
        t0 = time.perf_counter()
        status = cli_infer.main(["--checkpoint", ckpt_dir, "--input",
                                 vol_path, "--output", out_path, *extra])
        wall = time.perf_counter() - t0
        labels = np.load(out_path)
        m = f1_iou50_on_card(labels, sv.labels)
        c = center_f1_on_card(labels, sv.labels)
        f1[tag] = m["f1"]
        print(f"[9] cli.infer, trained checkpoint, {tag} post-processing, "
              f"{MAIN_SHAPE}: status {status}, {m['n_pred']} instances vs "
              f"{m['n_gt']} GT, F1@IoU0.5 {m['f1']:.4f}, center F1 "
              f"{c['f1']:.4f} "
              f"(wall {wall:.1f} s incl. set-up)")
        if status != 0:
            raise AssertionError(f"cli.infer returned {status}")
    for tag in ("calibrated", "calibrated, fused apply"):
        if f1[tag] < 0.5:
            raise AssertionError(f"trained quality: {tag}: F1@IoU0.5 "
                                 f"{f1[tag]:.4f} < 0.5")
    return ckpt_dir, vol_path, ann_path, f1["calibrated"]


def phase_bench_configs(sv, ckpt_dir: str, vol_path: str, ann_path: str,
                        f1_floor: float, tmp: str):
    """``cli.infer`` with phase 9's trained checkpoint on the 96x512x512
    stack under the two inference configurations of the JAX package's
    ``bench.py``, neither of which the default tile exercises: (a) the whole
    volume as one tile (96, 512, 512) with no halo in float32 through the
    module forward; (b) two tiles (96, 256, 512) with halo (0, 8, 0) in
    bf16 through the fused eval apply (K4 on blocks of 96 x 272 x 512),
    peak threshold 0.35. Both calibrated from the stack's weak annotations
    (``--calibrate-from``), so that F1@IoU0.5 means something on
    box-supervised masks: it must stay within 0.02 of phase 9's calibrated
    figure. (b) must launch K4 3 x 2 times, all on the tensor cores; both
    must launch K1-K3 and report convergence. Nothing is caught: a shape a
    kernel or cuDNN cannot take fails the phase."""
    from tpuseg_torch.cli import infer as cli_infer

    configs = (
        ("a: fp32, one tile (96,512,512), no halo, module forward", None,
         ['infer.compute_dtype="float32"', "infer.tile=[96,512,512]",
          "infer.halo=[0,0,0]"]),
        ("b: bf16, tiles (96,256,512) + halo (0,8,0), fused apply, peak "
         "threshold 0.35", 2,
         ["infer.tile=[96,256,512]", "infer.halo=[0,8,0]",
          'infer.apply_impl="fused"', "postproc.peak_threshold=0.35"]))
    vox = int(np.prod(MAIN_SHAPE))
    for tag, n_tiles, sets in configs:
        out_path = os.path.join(tmp, f"labels_bench_{tag[0]}.npy")
        argv = ["--checkpoint", ckpt_dir, "--input", vol_path, "--output",
                out_path, "--report-convergence", "--calibrate-from", ann_path]
        for kv in sets:
            argv += ["--set", kv]
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        status = cli_infer.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, mma = _launches(), _mma_launches()["fused_convblock"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        labels = np.load(out_path)
        m = f1_iou50_on_card(labels, sv.labels)
        print(f"[13] cli.infer, trained checkpoint, config {tag}: status "
              f"{status} ({'flood truncated' if status == 4 else 'converged'}"
              f"), wall {wall:.3f} s incl. load and save "
              f"({vox / wall / 1e6:.2f} Mvox/s), {m['n_pred']} instances vs "
              f"{m['n_gt']} GT, F1@IoU0.5 {m['f1']:.4f} (phase 9 calibrated: "
              f"{f1_floor:.4f}), peak device memory {peak_gb:.2f} GB; kernel "
              f"launches {launches}, {mma} of K4's by the tensor-core kernel")
        if status not in (0, 4):
            raise AssertionError(f"cli.infer (config {tag[0]}) returned "
                                 f"{status}")
        missing = [k for k in INFER_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"config {tag[0]} never launched {missing}")
        want_k4 = 3 * n_tiles if n_tiles else 0
        if launches["fused_convblock"] != want_k4 or mma != want_k4:
            raise AssertionError(
                f"config {tag[0]} launched K4 {launches['fused_convblock']} "
                f"times ({mma} on the tensor cores), not {want_k4}")
        if labels.shape != MAIN_SHAPE or m["f1"] < f1_floor - 0.02:
            raise AssertionError(
                f"config {tag[0]}: F1@IoU0.5 {m['f1']:.4f} is more than 0.02 "
                f"below phase 9's calibrated {f1_floor:.4f}")


def free_host_gb() -> float:
    """The host's available memory (``MemAvailable``) in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def f1_iou50_on_card(pred: np.ndarray, gt: np.ndarray) -> dict:
    """F1@IoU0.5 between two label volumes, from their contingency on the
    card (``instance_metrics``' numpy sorts take minutes at 10^8-10^9
    voxels). Pairs at IoU >= 0.5 are a one-to-one matching by themselves,
    so ``tp`` is their count, as in ``instance_metrics``."""
    p = torch.from_numpy(np.asarray(pred)).cuda().long().reshape(-1)
    g = torch.from_numpy(np.asarray(gt)).cuda().long().reshape(-1)
    n_g = int(g.max()) + 1
    p_area = torch.bincount(p)
    g_area = torch.bincount(g, minlength=n_g)
    both = (p > 0) & (g > 0)
    pairs, inter = torch.unique(p[both] * n_g + g[both], return_counts=True)
    pi, gi = pairs // n_g, pairs % n_g
    iou = inter.double() / (p_area[pi] + g_area[gi] - inter).double()
    tp = int((iou >= 0.5).sum())
    n_pred = int((p_area[1:] > 0).sum())
    n_gt = int((g_area[1:] > 0).sum())
    del p, g, both
    torch.cuda.empty_cache()
    return {"f1": 2 * tp / (n_pred + n_gt) if n_pred + n_gt else 0.0,
            "tp": tp, "n_pred": n_pred, "n_gt": n_gt}


class PassTally:
    """The K2 and K3 passes that ran inside the ``with`` (the loops enqueue
    more passes than run): ``ops.resolve``'s two loops are wrapped and each
    call's gates kept. A loop sets ``.last_gates`` on the name it is called
    by, here the wrapper. ``passes()`` reads them on the host, after the
    ``with``: (chase, flood) passes run in all."""

    NAMES = ("chase_resolve", "flood_resolve")

    def __enter__(self):
        from tpuseg_torch.ops import resolve

        self.module, self.gates = resolve, []
        self.orig = {n: getattr(resolve, n) for n in self.NAMES}
        for slot, name in enumerate(self.NAMES):
            setattr(resolve, name, self._counted(slot, name))
        return self

    def _counted(self, slot, name):
        def counted(*args, **kwargs):
            out = self.orig[name](*args, **kwargs)
            self.gates.append((slot, counted.last_gates))
            return out
        return counted

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)

    def passes(self) -> tuple:
        from tpuseg_torch.ops.resolve import passes_run

        ran = [0, 0]
        for slot, gates in self.gates:
            ran[slot] += passes_run(gates)
        return tuple(ran)


class ChunkPasses:
    """Chase and flood passes per chunk of a stream: the streaming module's
    watershed is wrapped for the time of the ``with``, and each call's K2
    and K3 passes that ran are kept (``PassTally``)."""

    def __enter__(self):
        from tpuseg_torch.infer import streaming

        self.module, self.orig, self.passes = streaming, streaming.watershed, []

        def counted(*args, **kwargs):
            with PassTally() as tally:
                out = self.orig(*args, **kwargs)
            self.passes.append(tally.passes())
            return out

        streaming.watershed = counted
        return self.passes

    def __exit__(self, *exc):
        self.module.watershed = self.orig


class ChunkTwinCheck:
    """Every chunk of a stream held against the twins at the chunk's own
    shape: the streaming module's watershed is wrapped for the time of the
    ``with``; each call runs once more with ``plain=True`` on the same maps
    (K1-K3, or K5 under ``nms_impl="pallas"``, against their twins) and
    must give equal labels, and K5 is held against its twin on the chunk's
    peak map at the call's threshold and radius. Keeps each checked
    chunk's shape and instance count."""

    def __enter__(self):
        from tpuseg_torch.infer import streaming
        from tpuseg_torch.ops.nms import fused_peak_nms, fused_peak_nms_plain

        self.module, self.orig, self.checked = streaming, streaming.watershed, []

        def checked(fg, pk, **kw):
            got = self.orig(fg, pk, **kw)
            want = self.orig(fg, pk, **kw, plain=True)
            thr, radius = kw["peak_threshold"], kw["peak_radius"]
            seeds = fused_peak_nms(pk, thr, radius)
            seeds_plain = fused_peak_nms_plain(pk, thr, radius)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"chunk {tuple(fg.shape)}: watershed kernels != twins on "
                    f"{int((got != want).sum())} voxels")
            if not torch.equal(seeds, seeds_plain):
                raise AssertionError(f"chunk {tuple(fg.shape)}: K5 != twin")
            self.checked.append((tuple(fg.shape),
                                 int(torch.unique(got[got > 0]).numel())))
            del want, seeds, seeds_plain
            return got

        streaming.watershed = checked
        return self.checked

    def __exit__(self, *exc):
        self.module.watershed = self.orig


def split_labels(labels: np.ndarray, one_shot: np.ndarray, seams,
                 most: int = 4):
    """The labels of a volume that lie in more than one 6-connected piece:
    their number, and for the first ``most`` each piece's voxels and z
    range and the seams (first planes of a chunk) it reaches from either
    side, with the z range of the one-shot instance that holds most of the
    label."""
    from tpuseg_torch.ops import label_components

    lab = torch.from_numpy(labels).cuda()
    comps = label_components(lab).long()
    fg = lab > 0
    pairs = torch.unique(lab[fg].long() * 2 ** 32 + comps[fg])
    ids, n = torch.unique(pairs >> 32, return_counts=True)
    split = ids[n > 1]
    one = torch.from_numpy(one_shot).cuda()
    found = []
    for label in split[:most].tolist():
        z, y, x = torch.nonzero(lab == label, as_tuple=True)
        c = comps[z, y, x]
        pieces = []
        for cid in torch.unique(c).tolist():
            zz = z[c == cid]
            pieces.append({"voxels": int(zz.numel()),
                           "z": (int(zz.min()), int(zz.max())),
                           "seams": [s for s in seams if bool(
                               ((zz == s - 1) | (zz == s)).any())]})
        host = one[z, y, x]
        host = host[host > 0]
        extent = None
        if host.numel():
            inst = int(torch.mode(host).values)
            zi = torch.nonzero(one == inst, as_tuple=True)[0]
            extent = (inst, int(zi.min()), int(zi.max()))
        found.append({"label": label, "pieces": pieces,
                      "one_shot_instance_z": extent})
    n_split = int(split.numel())
    del lab, comps, fg, one
    torch.cuda.empty_cache()
    return n_split, found


def _run_cli_captured(argv):
    """``cli.infer.main(argv)`` with its standard output echoed and kept:
    ``(status, wall s, printed text)``."""
    import contextlib
    import io

    from tpuseg_torch.cli import infer as cli_infer

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        status = cli_infer.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print("".join(f"       | {line}\n" for line in buf.getvalue().splitlines()),
          end="")
    return status, wall, buf.getvalue()


def _stream_stats(printed: str) -> dict:
    for line in printed.splitlines():
        if line.startswith("stream stats: "):
            return json.loads(line[len("stream stats: "):])
    raise AssertionError("cli.infer --stream printed no stream stats")


def phase_stream_analytic(sv, tmp: str) -> dict:
    """(a) The streamed path with AnalyticNet (receptive field 0) under the
    default InferConfig in float32 (in bf16 the stream takes its sigmoid in
    float32, the one-shot path in bf16, as in the JAX package):
    ``stream_infer(chunk_z=96)`` at the default halo (``infer.shard_halo``)
    equals the one-shot ``make_infer_fn`` elementwise under default
    post-processing, ``merge_saddle_ratio=0.8`` and
    ``nms_impl="pallas"``; a run killed after chunk 1 and resumed into a
    memmap equals the uninterrupted run; a uint16 source equals its float32
    values. Returns the launches of the pallas stream (K5) and of the
    merge's stream (M1 and M2, one each an extended chunk)."""
    import dataclasses

    from tpuseg_torch.core import Config, InferConfig
    from tpuseg_torch.infer import make_infer_fn, stream_infer

    model = AnalyticNet().cuda()
    vox = sv.image.size
    base = Config(infer=InferConfig(compute_dtype="float32"))
    settings = (("default", {}), ("merge_saddle_ratio=0.8",
                                  {"merge_saddle_ratio": 0.8}),
                ('nms_impl="pallas"', {"nms_impl": "pallas"}))
    default_labels, counted = None, {}
    for tag, post in settings:
        cfg = dataclasses.replace(base, postproc=dataclasses.replace(
            base.postproc, **post))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        want = make_infer_fn(model, cfg)(
            torch.from_numpy(sv.image).cuda()).cpu().numpy()
        one_s = time.perf_counter() - t0
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        _reset_launches()
        stats = {}
        t0 = time.perf_counter()
        got = stream_infer(model, cfg, sv.image, chunk_z=STREAM_CHUNK,
                           stats=stats)
        wall = time.perf_counter() - t0
        launches = _launches()
        same = np.array_equal(got, want)
        print(f"[14a] AnalyticNet, {tag}: streamed "
              f"{'==' if same else '!='} one-shot elementwise "
              f"({int(want.max())} instances); stream {wall:.3f} s "
              f"({vox / wall / 1e6:.2f} Mvox/s; stages "
              + ", ".join(f"{k} {stats[k]:.3f} s" for k in (
                  "t_normalize_pass", "t_calibrate_pass", "t_chunks",
                  "t_finalize"))
              + f"), peak device memory "
              f"{stats['peak_device_bytes'] / 1e9:.2f} GB; one-shot "
              f"{one_s:.3f} s, peak {one_peak:.2f} GB; kernel launches "
              f"{launches}")
        if not same:
            raise AssertionError(f"[14a] {tag}: streamed != one-shot on "
                                 f"{int((got != want).sum())} voxels")
        del got
        if tag == "default":
            default_labels = want
        else:
            if tag.startswith("nms"):
                counted["fused_peak_nms"] = launches["fused_peak_nms"]
                if not counted["fused_peak_nms"] or not np.array_equal(
                        want, default_labels):
                    raise AssertionError("[14a] nms_impl=pallas: K5 not "
                                         "launched or labels != default")
            else:
                chunks = -(-sv.image.shape[0] // STREAM_CHUNK)
                counted.update({k: launches[k] for k in PAIR_KERNELS})
                if any(counted[k] != chunks for k in PAIR_KERNELS):
                    raise AssertionError(f"[14a] {tag}: M1/M2 launched "
                                         f"{counted}, not once a chunk")
            del want

    # killed after chunk 1, resumed into a memmap
    class Killed(Exception):
        pass

    def killer(ci):
        if ci >= 1:
            raise Killed()

    rdir = os.path.join(tmp, "stream_resume")
    out = np.lib.format.open_memmap(os.path.join(tmp, "stream_resume.npy"),
                                    mode="w+", dtype=np.int32,
                                    shape=sv.image.shape)
    try:
        stream_infer(model, base, sv.image, out=out, chunk_z=STREAM_CHUNK,
                     resume_dir=rdir, on_chunk_done=killer)
        raise AssertionError("[14a] the killed stream was not killed")
    except Killed:
        pass
    resumed_at = []
    got = stream_infer(model, base, sv.image, out=out, chunk_z=STREAM_CHUNK,
                       resume_dir=rdir, on_chunk_done=resumed_at.append)
    same = np.array_equal(got, default_labels)
    print(f"[14a] killed after chunk 1, resumed at chunk {resumed_at[0]} into "
          f"an np.memmap: {'==' if same else '!='} the uninterrupted run")
    if not same or resumed_at[0] != 2:
        raise AssertionError("[14a] kill and resume")
    del got, out

    # a uint16 source uploads at 2 bytes a voxel and is cast on the card
    probe = torch.arange(0, 65536, 4099, dtype=torch.int32)
    on_card = probe.to(torch.uint16).cuda().float().cpu()
    print(f"[14a] torch.uint16 -> float32 on the card: "
          f"{'exact' if torch.equal(on_card, probe.float()) else 'WRONG'}")
    cut = (sv.image[:STREAM_CHUNK + 8, :256, :256] * 65535).astype(np.uint16)
    a = stream_infer(model, base, cut, chunk_z=STREAM_CHUNK // 2)
    b = stream_infer(model, base, cut.astype(np.float32),
                     chunk_z=STREAM_CHUNK // 2)
    if not torch.equal(on_card, probe.float()) or not np.array_equal(a, b):
        raise AssertionError("[14a] uint16 source != float32 source")
    print(f"[14a] uint16 source {cut.shape} == its float32 values "
          f"({int(a.max())} instances)")
    return counted


def phase_stream_trained(sv, ckpt_dir: str, tmp: str) -> dict:
    """(b) The trained full-width U-Net (phase 9's checkpoint) through the
    entry point: ``cli.infer --stream 96 --report-convergence --validate
    --calibrate-from`` with ``infer.apply_impl="fused"``, beside the
    one-shot ``cli.infer`` with the same flags. The streamed F1@IoU0.5 may
    be at most 0.02 below the one-shot's (the net's receptive-field radius,
    53, exceeds the halo of 32); K1-K3 launch at least once a chunk, K4
    exactly 3 x tiles per extended chunk x chunks x 2 (passes 1b and 2),
    all on the tensor cores. The same stream at the threshold pass 1b
    found runs with the copies overlapped and in sequence, in turns, and
    must give the call's labels. Then the first 180 planes stream the same
    way: the stream's own peak device memory, and the whole call's with
    the validation by chunks, must be within 10% of the full run's.
    Returns the streamed run's launches."""
    from tpuseg_torch.cli.infer import calibrated
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import save_annotations
    from tpuseg_torch.infer import stream_infer
    from tpuseg_torch.infer.tiles import tile_grid

    vol_path = os.path.join(tmp, "stream_volume.npy")
    ann_path = os.path.join(tmp, "stream_annotations.npz")
    np.save(vol_path, sv.image)
    save_annotations(ann_path, sv.centers, sv.half_sizes)
    D, H, W = sv.image.shape
    vox = sv.image.size
    cfg = Config()
    n_chunks = -(-D // STREAM_CHUNK)
    ext_shape = (STREAM_CHUNK + 2 * cfg.infer.shard_halo, H, W)
    tiles = len(tile_grid(ext_shape, cfg.infer.tile))
    want_k4 = 3 * tiles * n_chunks * 2

    def argv(path, ann, out, *extra):
        return ["--checkpoint", ckpt_dir, "--input", path, "--output", out,
                "--report-convergence", "--validate", "--calibrate-from",
                ann, "--set", 'infer.apply_impl="fused"', *extra]

    results = {}
    for tag, extra in (("one-shot", ()),
                       ("streamed", ("--stream", str(STREAM_CHUNK)))):
        out = os.path.join(tmp, f"stream_labels_{tag}.npy")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with ChunkPasses() as passes:
            status, wall, printed = _run_cli_captured(
                argv(vol_path, ann_path, out, *extra))
        launches, mma = _launches(), _mma_launches()["fused_convblock"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        m = f1_iou50_on_card(np.load(out), sv.labels)
        results[tag] = dict(status=status, wall=wall, printed=printed,
                            launches=launches, mma=mma, peak=peak, f1=m,
                            passes=list(passes), path=out)
        line = (f"[14b] cli.infer {tag}, trained checkpoint, fused apply, "
                f"calibrated: status {status}, wall {wall:.3f} s incl. load, "
                f"validation and save ({vox / wall / 1e6:.2f} Mvox/s), "
                f"{m['n_pred']} instances vs {m['n_gt']} GT, F1@IoU0.5 "
                f"{m['f1']:.4f}, peak device memory {peak:.2f} GB (whole "
                f"call)")
        if tag == "streamed":
            st = _stream_stats(printed)
            results[tag]["stats"] = st
            line += (f", the stream's own {st['peak_device_bytes'] / 1e9:.2f}"
                     " GB; stages " + ", ".join(
                         f"{k} {st[k]:.3f} s" for k in (
                             "t_normalize_pass", "t_calibrate_pass",
                             "t_chunks", "t_finalize"))
                     + f"; chase / flood passes per chunk "
                     + ", ".join(f"{c} / {f}" for c, f in passes))
        print(line + f"; kernel launches {launches}, {mma} of K4's on the "
              "tensor cores")
        if status not in (0, 4) or "connectivity validation: OK" not in \
                printed:
            raise AssertionError(f"[14b] {tag}: status {status} or the "
                                 "validation failed")
    one, st = results["one-shot"], results["streamed"]
    between = f1_iou50_on_card(np.load(st["path"]), np.load(one["path"]))
    print(f"[14b] streamed vs one-shot labels: F1@IoU0.5 {between['f1']:.4f} "
          f"({between['tp']} matched of {between['n_pred']} / "
          f"{between['n_gt']})")
    if st["f1"]["f1"] < one["f1"]["f1"] - 0.02:
        raise AssertionError(f"[14b] streamed F1@IoU0.5 {st['f1']['f1']:.4f}"
                             f" is more than 0.02 below the one-shot's "
                             f"{one['f1']['f1']:.4f}")
    few = [k for k in INFER_KERNELS if st["launches"][k] < n_chunks]
    if few:
        raise AssertionError(f"[14b] {few} launched fewer times than the "
                             f"{n_chunks} chunks: {st['launches']}")
    if st["launches"]["fused_convblock"] != want_k4 or st["mma"] != want_k4:
        raise AssertionError(
            f"[14b] K4 launched {st['launches']['fused_convblock']} times "
            f"({st['mma']} on the tensor cores), not 3 x {tiles} tiles x "
            f"{n_chunks} chunks x 2 passes = {want_k4}")

    # the chunks' copies overlapped with compute against in sequence, in
    # turns, on this traffic; the threshold pass 1b found is fixed, so each
    # run is pass 1, pass 2 and the finalize, and must give the same labels
    model = trained_model(ckpt_dir, cfg)
    fixed = calibrated(cfg.override(**{"infer.apply_impl": "fused"}),
                       ann_path, vox)
    fixed = fixed.override(**{"postproc.fg_target_fraction": 0.0,
                              "postproc.fg_threshold":
                                  st["stats"]["fg_threshold"]})
    want = np.load(st["path"])
    turns = {"overlapped": [], "sequential": []}
    for mode in ("overlapped", "sequential", "sequential", "overlapped"):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stream_infer(model, fixed, sv.image, chunk_z=STREAM_CHUNK,
                           stats=stats, overlap=mode == "overlapped")
        wall = time.perf_counter() - t0
        if not np.array_equal(got, want):
            raise AssertionError(f"[14b] {mode} stream at the fixed "
                                 "threshold != the cli.infer stream")
        turns[mode].append((wall, stats["t_chunks"]))
        del got
    print("[14b] trained stream, threshold fixed, in turns (wall / pass 2 "
          "s): " + "; ".join(f"{mode} " + ", ".join(
              f"{w:.3f} / {c:.3f}" for w, c in ts) for mode, ts in
                              turns.items()))
    del model, want
    torch.cuda.empty_cache()

    # memory follows the chunk: the first 180 planes, streamed the same way
    # (calibrated from the annotations of the nuclei centred there)
    half_path = os.path.join(tmp, "stream_volume_half.npy")
    np.save(half_path, sv.image[:D // 2])
    inside = sv.centers[:, 0] < D // 2
    half_ann = os.path.join(tmp, "stream_annotations_half.npz")
    save_annotations(half_ann, sv.centers[inside], sv.half_sizes[inside])
    torch.cuda.reset_peak_memory_stats()
    status, wall, printed = _run_cli_captured(
        argv(half_path, half_ann, os.path.join(tmp, "stream_labels_half.npy"),
             "--stream", str(STREAM_CHUNK)))
    call = torch.cuda.max_memory_allocated() / 1e9
    half = _stream_stats(printed)["peak_device_bytes"] / 1e9
    full = st["stats"]["peak_device_bytes"] / 1e9
    print(f"[14b] peak device memory of the stream: {D // 2} planes "
          f"{half:.2f} GB, {D} planes {full:.2f} GB; of the whole call with "
          f"the chunked validation: {call:.2f} GB, {st['peak']:.2f} GB "
          f"(one-shot call {one['peak']:.2f} GB); the {D // 2}-plane stream "
          f"took {wall:.3f} s, status {status}")
    if abs(half - full) > 0.1 * full or abs(call - st["peak"]) > 0.1 * \
            st["peak"]:
        raise AssertionError("[14b] the stream's device memory does not "
                             "follow the chunk")
    if status not in (0, 4) or "connectivity validation: OK" not in printed:
        raise AssertionError(f"[14b] the {D // 2}-plane stream: status "
                             f"{status} or the validation failed")
    return st["launches"]


def trained_model(ckpt_dir: str, cfg):
    """Phase 9's checkpoint on the card, loaded as ``cli.infer`` loads it."""
    from tpuseg_torch.cli.common import load_model_state
    from tpuseg_torch.models import build_model

    model = build_model(cfg.model)
    model.load_state_dict(load_model_state(ckpt_dir))
    return model.to("cuda")


def phase_stream_seams(sv, ckpt_dir: str, tmp: str) -> None:
    """(c) The first 180 planes calibrated from the whole stack's
    annotations: twice the nuclei the half holds, so twice its foreground
    fraction, a lower threshold and larger, merged instances; the input on
    which ``--validate`` first failed. The one-shot path must give
    connected instances (by construction); the stream runs at the default
    halo (32) and at 56 (above the net's receptive-field radius, 53), every
    chunk held against the twins (``ChunkTwinCheck``: K1-K3 and K5 at the
    extended chunks' shapes, (160, 1024, 1024) and (208, 1024, 1024)); each
    stream's validation is printed, and each label in more than one piece
    is located against the seam and beside its one-shot instance."""
    from tpuseg_torch.cli.infer import calibrated
    from tpuseg_torch.core import Config
    from tpuseg_torch.infer import make_infer_fn, stream_infer
    from tpuseg_torch.ops import labels_are_connected

    ann_path = os.path.join(tmp, "stream_annotations.npz")
    D = sv.image.shape[0] // 2
    half = sv.image[:D]
    cfg = calibrated(Config().override(**{"infer.apply_impl": "fused"}),
                     ann_path, half.size)
    model = trained_model(ckpt_dir, cfg)
    one = make_infer_fn(model, cfg)(torch.from_numpy(half).cuda())
    one = one.cpu().numpy()
    one_ok = labels_are_connected(one)
    print(f"[14c] {half.shape} calibrated from all {len(sv.centers)} nuclei "
          f"(fg_target_fraction {cfg.postproc.fg_target_fraction:.5f}): "
          f"one-shot {int(one.max())} instances, connected: {one_ok}")
    if not one_ok:
        raise AssertionError("[14c] the one-shot labels are not connected")
    seams = list(range(STREAM_CHUNK, D, STREAM_CHUNK))
    for halo in (32, 56):
        stats = {}
        with ChunkTwinCheck() as checked:
            got = stream_infer(model, cfg, half, chunk_z=STREAM_CHUNK,
                               halo=halo, stats=stats)
        ok = labels_are_connected(got, chunk_z=STREAM_CHUNK)
        m = f1_iou50_on_card(got, one)
        print(f"[14c] halo {halo}: chunks {checked} == twins (K1-K3 and K5); "
              f"{int(got.max())} instances, F1@IoU0.5 against the one-shot "
              f"{m['f1']:.4f}, fg threshold {stats['fg_threshold']:.5f}, "
              f"connected: {ok}")
        if not ok:
            n_split, found = split_labels(got, one, seams)
            print(f"[14c] halo {halo}: {n_split} labels in more than one "
                  f"piece (seams at planes {seams}): {found}")
        del got
    del model
    torch.cuda.empty_cache()


def phase_stream(ckpt_dir: str, tmp: str):
    """Phase 14: the streamed path on the card (runs after phase 9, with
    its checkpoint). Returns the streamed launches and the stack."""
    from tpuseg_torch.data import synthesize_volume

    free = free_host_gb()
    print("[14] free -g:\n" + subprocess.run(
        ["free", "-g"], capture_output=True, text=True).stdout.rstrip())
    shape, n_inst = STREAM_SHAPE, STREAM_INSTANCES
    if free < STREAM_MIN_FREE_GB:
        shape, n_inst = STREAM_CUT, STREAM_CUT_INSTANCES
        print(f"[14] the host has {free:.1f} GB free, under "
              f"{STREAM_MIN_FREE_GB}: the stack is cut to {shape} with "
              f"{n_inst} nuclei")
    t0 = time.perf_counter()
    sv = synthesize_volume(shape=shape, num_instances=n_inst, seed=SEED)
    print(f"[14] synthesized {shape} with {n_inst} nuclei in "
          f"{time.perf_counter() - t0:.1f} s ({sv.image.size / 1e6:.1f} Mvox, "
          f"{free:.1f} GB free before)", flush=True)
    # the card helper against the port's instance_metrics on a crop
    from tpuseg_torch.eval import instance_metrics

    crop = (slice(0, 48), slice(0, 256), slice(0, 256))
    lab = np.ascontiguousarray(sv.labels[crop])
    noisy = np.where(np.roll(lab, 2, axis=2) > 0, np.roll(lab, 2, axis=2), 0)
    a, b = f1_iou50_on_card(noisy, lab), instance_metrics(noisy, lab)
    if abs(a["f1"] - b["f1"]) > 1e-12 or a["tp"] != b["tp"]:
        raise AssertionError(f"[14] F1 on the card {a} != instance_metrics "
                             f"{b}")
    launches = phase_stream_analytic(sv, tmp)       # K5's, under "pallas"
    _add_launches(launches, phase_stream_trained(sv, ckpt_dir, tmp))
    phase_stream_seams(sv, ckpt_dir, tmp)
    return {k: launches[k] for k in STREAM_KERNELS + PAIR_KERNELS}, sv


def _add_launches(acc: dict, launches=None) -> None:
    """Adds ``launches`` (default: those since the last reset) into
    ``acc``."""
    for k, n in (_launches() if launches is None else launches).items():
        acc[k] = acc.get(k, 0) + n


def _card_mesh(shape, axes=("z", "y")):
    """A mesh of ``shape`` with every shard on ``cuda:0``."""
    from tpuseg_torch.parallel import Mesh

    return Mesh(["cuda:0"] * int(np.prod(shape)), axes[:len(shape)], shape)


def _sharded(model, cfg, mesh, volume, **kw):
    """``make_sharded_infer_fn``'s labels of ``volume`` as one numpy array,
    the call's wall seconds (upload and gather included) and its peak
    device memory in GB."""
    from tpuseg_torch.infer import make_sharded_infer_fn, shard_volume, unshard

    z_offset = kw.pop("z_offset", 0)
    infer = make_sharded_infer_fn(model, cfg, mesh, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    labels = unshard(infer(shard_volume(volume, mesh), z_offset=z_offset),
                     mesh)
    return (labels, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def phase_sharded_analytic(sv, acc: dict) -> None:
    """(a) AnalyticNet in float32 on the pre-normalized 96x512x512 stack
    (``normalize=False``), shards on ``cuda:0``: ``make_sharded_infer_fn``
    on a z2 mesh (extended slabs (112, 512, 512)) and a (2, 2) mesh
    ((112, 320, 512)) equals the one-shot ``make_infer_fn`` elementwise
    under default post-processing, ``fg_target_fraction`` calibration,
    merge 0.8 and ``nms_impl="pallas"``; the default and the pallas calls
    once more with ``plain=True`` (K1-K3 and K5 against their twins at
    every shard's shape) must give the same labels, and the default once
    more at ``z_offset=3_000_000``. Then one ``normalize=True`` leg on the
    raw stack: the sharded percentile scalars beside the one-shot's (equal:
    int64 counts) and the label agreement."""
    import dataclasses

    from tpuseg_torch.core import Config, InferConfig
    from tpuseg_torch.data.normalize import (histogram_percentile_normalize,
                                             histogram_percentile_scalars)
    from tpuseg_torch.infer import make_infer_fn, shard_volume
    from tpuseg_torch.infer.sharded import global_histogram_percentile
    from tpuseg_torch.ops.calibrate import expected_fg_fraction

    model = AnalyticNet().cuda()
    base = Config(infer=InferConfig(compute_dtype="float32"))
    v = histogram_percentile_normalize(
        torch.from_numpy(sv.image)[None].cuda())[0].cpu().numpy()
    frac = expected_fg_fraction(sv.half_sizes, sv.image.size)
    settings = (("default", {}),
                (f"fg_target_fraction={frac:.5f}",
                 {"fg_target_fraction": frac}),
                ("merge_saddle_ratio=0.8", {"merge_saddle_ratio": 0.8}),
                ('nms_impl="pallas"', {"nms_impl": "pallas"}))
    for tag, post in settings:
        cfg = dataclasses.replace(base, postproc=dataclasses.replace(
            base.postproc, **post))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        want = make_infer_fn(model, cfg, normalize=False)(
            torch.from_numpy(v).cuda()).cpu().numpy()
        one_s = time.perf_counter() - t0
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        for name, shape in (("z2", (2,)), ("(2,2)", (2, 2))):
            mesh = _card_mesh(shape)
            _reset_launches()
            got, wall, peak = _sharded(model, cfg, mesh, v, normalize=False)
            _add_launches(acc)
            launches = _launches()
            same = np.array_equal(got, want)
            line = (f"[15a] AnalyticNet, {tag}, mesh {name}: sharded "
                    f"{'==' if same else '!='} one-shot elementwise "
                    f"({int(want.max())} instances); sharded {wall:.3f} s, "
                    f"peak device memory {peak:.3f} GB, one-shot {one_s:.3f} "
                    f"s, {one_peak:.3f} GB; kernel launches {launches}")
            if not same:
                raise AssertionError(line + f"; {int((got != want).sum())} "
                                     "voxels differ")
            if tag == "default" or "pallas" in tag:
                twin, _, _ = _sharded(model, cfg, mesh, v, normalize=False,
                                   plain=True)
                if not np.array_equal(twin, got):
                    raise AssertionError(f"[15a] {tag}, mesh {name}: the "
                                         "kernels != their twins")
                line += "; == the twins (plain=True)"
            if tag == "default" and name == "(2,2)":
                far, _, _ = _sharded(model, cfg, mesh, v, normalize=False,
                                  z_offset=3_000_000)
                if not np.array_equal(far, got):
                    raise AssertionError("[15a] z_offset 3e6 changed the "
                                         "labels")
                line += "; z_offset 3e6 == 0"
            print(line, flush=True)
            if "pallas" in tag and not launches["fused_peak_nms"]:
                raise AssertionError("[15a] nms_impl=pallas never launched K5")
            del got
    # normalize=True on the raw stack, (2, 2) mesh
    mesh = _card_mesh((2, 2))
    pcts, stride = base.data.normalize_pcts, base.data.normalize_sample_stride
    sharded_s = [float(x) for x in global_histogram_percentile(
        shard_volume(sv.image, mesh), pcts, sample_stride=stride)]
    one_s = [float(x) for x in histogram_percentile_scalars(
        torch.from_numpy(sv.image).cuda(), pcts, sample_stride=stride)]
    want = make_infer_fn(model, base)(
        torch.from_numpy(sv.image).cuda()).cpu().numpy()
    _reset_launches()
    got, _, _ = _sharded(model, base, mesh, sv.image, normalize=True)
    _add_launches(acc)
    agree = float((got == want).mean())
    print(f"[15a] normalize=True, mesh (2,2): percentile scalars sharded "
          f"{sharded_s}, one-shot {one_s}; label agreement {agree:.7f} "
          f"({int(got.max())} / {int(want.max())} instances)")
    if sharded_s != one_s or agree != 1.0:
        raise AssertionError("[15a] normalize=True: sharded != one-shot")


def _cli_labels(argv, tag: str):
    """``cli.infer`` through ``_run_cli_captured``, its kernel counts set to
    0 just before and read just after: ``(wall, printed, labels, peak GB,
    launches, K4's tensor-core launches)``. The call must exit 0 with its
    ``--validate`` passed."""
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    status, wall, printed = _run_cli_captured(argv)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches, mma = _launches(), _mma_launches()["fused_convblock"]
    if status != 0 or "connectivity validation: OK" not in printed:
        raise AssertionError(f"[15] cli.infer {tag}: status {status} or the "
                             "validation failed")
    out = argv[argv.index("--output") + 1]
    return wall, printed, np.load(out), peak, launches, mma


def phase_sharded_trained(sv, ckpt_dir: str, vol_path: str, ann_path: str,
                          f1_floor: float, tmp: str, acc: dict) -> None:
    """(b) Phase 9's trained U-Net (32/64/128/256, bf16) through
    ``cli.infer --shard z2,y2 --calibrate-from --validate`` with the fused
    apply on the 96x512x512 stack, beside the one-shot call with the same
    flags (both must exit 0 with the validation passed): F1@IoU0.5 within 0.02 of phase 9's calibrated one-shot (the
    net's receptive-field radius, ~53, exceeds ``shard_halo`` 32, so this
    leg is instance-level), K1 launched once a shard (4), K4 3 x 48 tiles
    x 4 shards = 576 times, all on the tensor cores; wall time and peak
    device memory of both calls, and the extended slabs' voxels over the
    cores'."""
    from tpuseg_torch.core import Config
    from tpuseg_torch.infer.tiles import tile_grid

    cfg = Config()
    halo = cfg.infer.shard_halo
    D, H, W = MAIN_SHAPE
    ext = (D // 2 + 2 * halo, H // 2 + 2 * halo, W)
    want_k4 = 3 * len(tile_grid(ext, cfg.infer.tile)) * 4
    ratio = np.prod(ext) / (D // 2 * H // 2 * W)
    vox = int(np.prod(MAIN_SHAPE))
    res = {}
    for tag, extra in (("one-shot", ()), ("sharded z2,y2",
                                          ("--shard", "z2,y2"))):
        out = os.path.join(tmp, f"labels_15b_{len(res)}.npy")
        wall, printed, labels, peak, launches, mma = _cli_labels(
            ["--checkpoint", ckpt_dir, "--input", vol_path, "--output", out,
             "--calibrate-from", ann_path, "--validate", "--set",
             'infer.apply_impl="fused"', *extra], tag)
        if extra:
            _add_launches(acc, launches)
        m = f1_iou50_on_card(labels, sv.labels)
        res[tag] = m
        print(f"[15b] cli.infer {tag}, trained checkpoint, bf16, fused apply, "
              f"calibrated: validation OK, wall {wall:.3f} s incl. load, "
              f"validation and save ({vox / wall / 1e6:.2f} Mvox/s), peak "
              f"device memory {peak:.2f} GB, {m['n_pred']} instances vs "
              f"{m['n_gt']} GT, F1@IoU0.5 {m['f1']:.4f} (phase 9 calibrated "
              f"one-shot {f1_floor:.4f}); kernel launches {launches}, {mma} "
              "of K4's on the tensor cores", flush=True)
        if labels.shape != MAIN_SHAPE:
            raise AssertionError(f"[15b] {tag}: labels {labels.shape}")
    print(f"[15b] shards' extended slabs {ext} over cores "
          f"{(D // 2, H // 2, W)}: {ratio:.3f}x the voxels")
    if res["sharded z2,y2"]["f1"] < f1_floor - 0.02:
        raise AssertionError(f"[15b] sharded F1@IoU0.5 "
                             f"{res['sharded z2,y2']['f1']:.4f} is more than "
                             f"0.02 below phase 9's {f1_floor:.4f}")
    if launches["seed_chase_pass"] != 4 or launches["fused_convblock"] != \
            want_k4 or mma != want_k4:
        raise AssertionError(f"[15b] K1 {launches['seed_chase_pass']} (want "
                             f"4), K4 {launches['fused_convblock']} ({mma} "
                             f"on the tensor cores; want {want_k4})")


def phase_sharded_stream(sv, stream_sv, ckpt_dir: str, vol_path: str,
                         ann_path: str, f1_floor: float, tmp: str,
                         acc: dict) -> None:
    """(c) The streamed x sharded composition: AnalyticNet in float32,
    ``stream_infer(chunk_z=96, mesh=<4 y-shards on cuda:0>)`` on phase 14's
    stack (or a 180x1024x1024 one when phase 14 did not run) equals the
    single-device ``stream_infer`` elementwise at merge 0 and 0.8; then
    ``cli.infer --stream 96 --stream-shard 4`` once, with phase 9's
    checkpoint on the 96x512x512 stack (fused apply, calibrated,
    ``--validate``, which must pass): F1@IoU0.5 within 0.02 of phase 9's
    one-shot, K1 launched once a y-shard of the one chunk (4), K4 3 x
    tiles of a y-shard's extended slab x 4 x 2 (passes 1b and 2), all on
    the tensor cores."""
    import dataclasses

    from tpuseg_torch.core import Config, InferConfig
    from tpuseg_torch.data import synthesize_volume
    from tpuseg_torch.infer import stream_infer
    from tpuseg_torch.infer.tiles import tile_grid

    if stream_sv is None:
        t0 = time.perf_counter()
        stream_sv = synthesize_volume(shape=(180, 1024, 1024),
                                      num_instances=STREAM_INSTANCES // 2,
                                      seed=SEED)
        print(f"[15c] synthesized (180, 1024, 1024) in "
              f"{time.perf_counter() - t0:.1f} s")
    image = stream_sv.image
    model = AnalyticNet().cuda()
    mesh = _card_mesh((4,), axes=("y",))
    base = Config(infer=InferConfig(compute_dtype="float32"))
    for ratio in (0.0, 0.8):
        cfg = dataclasses.replace(base, postproc=dataclasses.replace(
            base.postproc, merge_saddle_ratio=ratio))
        t0 = time.perf_counter()
        want = stream_infer(model, cfg, image, chunk_z=STREAM_CHUNK)
        one_s = time.perf_counter() - t0
        _reset_launches()
        stats = {}
        t0 = time.perf_counter()
        got = stream_infer(model, cfg, image, chunk_z=STREAM_CHUNK,
                           mesh=mesh, stats=stats)
        wall = time.perf_counter() - t0
        _add_launches(acc)
        same = np.array_equal(got, want)
        print(f"[15c] AnalyticNet {image.shape}, merge {ratio}: y-sharded "
              f"stream (4 shards) {'==' if same else '!='} single-device "
              f"stream elementwise ({int(want.max())} instances); sharded "
              f"{wall:.3f} s (stages " + ", ".join(
                  f"{k} {stats[k]:.3f} s" for k in (
                      "t_normalize_pass", "t_calibrate_pass", "t_chunks",
                      "t_finalize"))
              + f"; peak device memory {stats['peak_device_bytes'] / 1e9:.2f}"
              f" GB), single-device {one_s:.3f} s; kernel launches "
              f"{_launches()}", flush=True)
        if not same:
            raise AssertionError(f"[15c] merge {ratio}: sharded stream != "
                                 f"stream on {int((got != want).sum())} "
                                 "voxels")
        del got, want
    del model
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "labels_15c.npy")
    wall, printed, labels, peak, launches, mma = _cli_labels(
        ["--checkpoint", ckpt_dir, "--input", vol_path, "--output", out,
         "--stream", str(STREAM_CHUNK), "--stream-shard", "4",
         "--calibrate-from", ann_path, "--validate", "--set",
         'infer.apply_impl="fused"'], "--stream-shard 4")
    _add_launches(acc, launches)
    # one chunk of 4 y-shards, each swept in passes 1b and 2
    cfg = Config()
    D, H, W = MAIN_SHAPE
    n_chunks = -(-D // STREAM_CHUNK)
    ext = (STREAM_CHUNK + 2 * cfg.infer.shard_halo,
           H // 4 + 2 * cfg.infer.shard_halo, W)
    want_k1 = n_chunks * 4
    want_k4 = 3 * len(tile_grid(ext, cfg.infer.tile)) * want_k1 * 2
    m = f1_iou50_on_card(labels, sv.labels)
    print(f"[15c] cli.infer --stream {STREAM_CHUNK} --stream-shard 4, trained "
          f"checkpoint, fused apply, calibrated, {MAIN_SHAPE}: validation "
          f"OK, wall {wall:.3f} s, peak device memory {peak:.2f} GB, "
          f"{m['n_pred']} instances vs {m['n_gt']} GT, F1@IoU0.5 "
          f"{m['f1']:.4f} (phase 9 calibrated one-shot {f1_floor:.4f}); "
          f"kernel launches {launches}, {mma} of K4's on the tensor cores")
    if "--stream-shard 4: Mesh" not in printed:
        raise AssertionError("[15c] cli.infer --stream-shard printed no mesh")
    if m["f1"] < f1_floor - 0.02:
        raise AssertionError(f"[15c] --stream-shard F1@IoU0.5 {m['f1']:.4f} "
                             f"is more than 0.02 below phase 9's "
                             f"{f1_floor:.4f}")
    if launches["seed_chase_pass"] != want_k1 or launches[
            "fused_convblock"] != want_k4 or mma != want_k4:
        raise AssertionError(
            f"[15c] K1 {launches['seed_chase_pass']} (want {want_k1}: "
            f"{n_chunks} chunk x 4 y-shards), K4 "
            f"{launches['fused_convblock']} ({mma} on the tensor cores; want "
            f"3 x {len(tile_grid(ext, cfg.infer.tile))} tiles of {ext} x "
            f"{want_k1} x 2 passes = {want_k4})")


def phase_sharded(sv, stream_sv, ckpt_dir: str, vol_path: str,
                  ann_path: str, f1_floor: float, tmp: str) -> dict:
    """Phase 15: the sharded paths with every shard on ``cuda:0`` (runs
    after phase 9, with its checkpoint, and after phase 14 where it ran,
    with its stack). Returns every kernel's launches summed over the
    sharded runs of (a)-(c)."""
    acc = {}
    phase_sharded_analytic(sv, acc)
    phase_sharded_trained(sv, ckpt_dir, vol_path, ann_path, f1_floor, tmp,
                          acc)
    phase_sharded_stream(sv, stream_sv, ckpt_dir, vol_path, ann_path,
                         f1_floor, tmp, acc)
    missing = [k for k in SHARDED_KERNELS if not acc.get(k)]
    if missing:
        raise AssertionError(f"[15] the sharded paths never launched "
                             f"{missing}: {acc}")
    return acc


# ---------------------------------------------------------------- phase 16


def _dp_config(dtype: str = "bfloat16"):
    """Phase 16's training configuration: the flagship net (32/64/128/256,
    head 32, bf16), fused apply, batch 8 of 64^3, lr 1e-3 with one warmup
    step (the first step runs at the full rate, as in the reference's DP
    tests)."""
    from tpuseg_torch.core import Config

    return Config().override(**{
        "model.compute_dtype": dtype, "train.apply_impl": "fused",
        "train.lr": 1e-3, "train.warmup_steps": 1,
        "train.total_steps": MP_DP_STEPS})


def _dp_batch(tmp: str, i: int) -> dict:
    """(a)'s global batch of step ``i + 1`` (host arrays)."""
    batches = np.load(os.path.join(tmp, "dp_batches.npz"))
    return {k[3:]: batches[k] for k in batches.files
            if k.startswith(f"{i:02d}_")}


def _f32_first_step(tmp: str, dp: bool):
    """(a)'s first step in float32 from the same weights and batch, where
    the sums' order leaves the averaged gradient far closer to the
    single-process one than bf16 rounding does: the gradient the optimizer
    is given (flattened, on the host) and its norm; under DP (``dp``) on
    this rank's 4 examples."""
    from tpuseg_torch.models import build_model
    from tpuseg_torch.train import (create_train_state, make_data_mesh,
                                    make_dp_train_step, make_train_step,
                                    shard_batch)

    cfg = _dp_config("float32")
    model = build_model(cfg.model)
    model.load_state_dict(torch.load(os.path.join(tmp, "dp_init.pt"),
                                     weights_only=True))
    model.cuda().train()
    state = create_train_state(model, cfg)
    grads, update = [], state.opt.update

    def kept(params, g, gnorm):        # the gradient AdamW is given
        grads.append(torch.cat([v.reshape(-1) for v in g.values()]).cpu())
        return update(params, g, gnorm)

    state.opt.update = kept
    batch = _dp_batch(tmp, 0)
    if dp:
        mesh = make_data_mesh()
        m = make_dp_train_step(model, cfg, mesh)(
            state, shard_batch(batch, mesh), 1)
    else:
        m = make_train_step(model, cfg)(state, {
            k: torch.from_numpy(v).cuda() for k, v in batch.items()}, 1)
    return grads[0], float(m["grad_norm"])


def _state_digest(model) -> str:
    """SHA-256 of every parameter's and running statistic's bytes."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


class _CollectiveTimer:
    """Wall seconds inside the data-parallel all-reduces (the gradient and
    metric buffer of ``train/step.py``, the BatchNorm statistics of
    ``models/blocks.py``), the card synchronized first so that earlier
    kernels are not billed to them."""

    def __init__(self):
        import tpuseg_torch.models.blocks as blocks
        import tpuseg_torch.train.step as step

        self.seconds = {"grad": 0.0, "bn": 0.0}
        for key, mod in (("grad", step), ("bn", blocks)):
            mod.group_mean = self._timed(key, mod.group_mean)

    def _timed(self, key, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t0
            return out
        return wrapped

    def take(self) -> dict:
        out = dict(self.seconds)
        self.seconds = dict.fromkeys(out, 0.0)
        return out


def _mp_worker_dp(tmp: str) -> dict:
    """(a) in one process: the DP steps of phase 16 on this rank's 4 of
    the 8 examples, per step its loss, gradient norm, wall ms, all-reduce
    seconds and the digest of its state; K6's launches over the steps;
    rank 0 saves the state of step 1 and the averaged gradient of step 1
    in float32 (run after the steps)."""
    from tpuseg_torch.models import build_model
    from tpuseg_torch.train import (create_train_state, make_data_mesh,
                                    make_dp_train_step, shard_batch)

    cfg = _dp_config()
    model = build_model(cfg.model)
    model.load_state_dict(torch.load(os.path.join(tmp, "dp_init.pt"),
                                     weights_only=True))
    model.cuda().train()
    state = create_train_state(model, cfg)
    mesh = make_data_mesh()
    step = make_dp_train_step(model, cfg, mesh)
    timer = _CollectiveTimer()
    rank = mesh.local_ranks()[0]
    _reset_launches()
    rec = {"steps": []}
    for i in range(MP_DP_STEPS):
        local = shard_batch(_dp_batch(tmp, i), mesh)
        torch.cuda.synchronize()
        timer.take()
        t0 = time.perf_counter()
        m = step(state, local, 1)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        rec["steps"].append({"loss": loss, "grad_norm": gnorm, "ms": ms, **{
            f"{k}_ms": 1e3 * s for k, s in timer.take().items()},
            "digest": _state_digest(model)})
        if i == 0 and rank == 0:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       os.path.join(tmp, "dp_step1.pt"))
    rec["launches"] = _launches()
    rec["mma_launches"] = _mma_launches()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, state, step
    grads, rec["f32_grad_norm"] = _f32_first_step(tmp, dp=True)
    if rank == 0:
        torch.save(grads, os.path.join(tmp, "dp_grads1_f32.pt"))
    return rec


def _mp_worker_cli(tmp: str) -> dict:
    """(c), (d) in one process: each ``cli.infer`` run named in
    ``DIR/cli_runs.json`` through its entry point, with its status, wall
    seconds, peak device memory, kernel launches and printed lines."""
    import contextlib
    import io

    from tpuseg_torch.cli import infer as cli_infer

    with open(os.path.join(tmp, "cli_runs.json")) as f:
        runs = json.load(f)
    rec = {}
    for tag, argv in runs.items():
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            status = cli_infer.main(argv)
        torch.cuda.synchronize()
        rec[tag] = {"status": status, "wall": time.perf_counter() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": _launches(), "mma_launches": _mma_launches(),
                    "tile_launches": _tile_launches(),
                    "printed": buf.getvalue()}
    return rec


def _mp_worker_nccl(tmp: str) -> dict:
    """(e): on a group of one (NCCL), one DP step of (a)'s configuration
    beside the step without a group on the same weights and batch, and
    the ``cli.infer`` runs of ``DIR/cli_runs.json``."""
    from tpuseg_torch.models import build_model
    from tpuseg_torch.train import (create_train_state, make_data_mesh,
                                    make_dp_train_step, make_train_step,
                                    shard_batch)

    cfg = _dp_config()
    batch = _dp_batch(tmp, 0)
    digests, losses = [], []
    for grouped in (True, False):
        model = build_model(cfg.model)
        model.load_state_dict(torch.load(os.path.join(tmp, "dp_init.pt"),
                                         weights_only=True))
        model.cuda().train()
        state = create_train_state(model, cfg)
        if grouped:
            mesh = make_data_mesh()
            m = make_dp_train_step(model, cfg, mesh)(
                state, shard_batch(batch, mesh), 1)
        else:
            m = make_train_step(model, cfg)(state, {
                k: torch.from_numpy(v).cuda() for k, v in batch.items()}, 1)
        losses.append(float(m["loss"]))
        digests.append(_state_digest(model))
        del model, state
        torch.cuda.empty_cache()
    return {"digests": digests, "losses": losses, **_mp_worker_cli(tmp)}


MP_WORKERS = {"dp": _mp_worker_dp, "cli": _mp_worker_cli,
              "nccl": _mp_worker_nccl}


def mp_worker(leg: str, tmp: str) -> None:
    """``chip_smoke.py --worker LEG DIR``: one process of phase 16, started
    by it under the ``TPUSEG_*`` environment; writes its record to
    ``DIR/<leg>_rank<r>.json``."""
    from tpuseg_torch.parallel.multihost import (backend, initialize,
                                                 process_count,
                                                 process_device,
                                                 process_index, shutdown)

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    initialize(device="cuda")
    rank = process_index()
    print(f"[16] worker {leg}: process {rank}/{process_count()} on "
          f"{process_device()}, backend {backend()}", flush=True)
    rec = MP_WORKERS[leg](tmp)
    rec.update(device=str(process_device()), backend=backend())
    with open(os.path.join(tmp, f"{leg}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(argv, n: int, tmp: str, backend=None, timeout: int = 300):
    """``python3 argv`` as ``n`` processes of one group on this host
    (``TPUSEG_COORDINATOR`` / ``TPUSEG_NUM_PROCESSES`` /
    ``TPUSEG_PROCESS_ID``, and ``TPUSEG_DIST_BACKEND`` when given), every
    one on ``cuda:0`` with one card; their outputs, echoed. Any process
    that fails or outlives ``timeout`` fails the phase, and every process
    is ended before this returns."""
    import sys

    env = dict(os.environ, TPUSEG_COORDINATOR=f"127.0.0.1:{_free_port()}",
               TPUSEG_NUM_PROCESSES=str(n))
    env.pop("TPUSEG_DIST_BACKEND", None)
    if backend:
        env["TPUSEG_DIST_BACKEND"] = backend
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(tmp, f"proc{r}.log"), "w+") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, *argv], cwd=here,
                              env=dict(env, TPUSEG_PROCESS_ID=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(n)]
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        outs.append(log.read())
        log.close()
        print("".join(f"       | {r}: {line}\n"
                      for line in outs[-1].splitlines()[-12:]), end="")
        if p.returncode != 0:
            raise AssertionError(f"[16] process {r} of {argv} exited "
                                 f"{p.returncode}:\n{outs[-1][-4000:]}")
    return outs


def _worker_records(leg: str, tmp: str, n: int) -> list:
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"{leg}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _sum_launches(acc: dict, recs) -> None:
    for rec in recs:
        _add_launches(acc, rec["launches"])


def phase_mp_dp(tmp: str, acc: dict) -> str:
    """(a) DP training at full width in 2 processes on gloo (both on
    ``cuda:0``), against the single-process steps on the same batches."""
    from tpuseg_torch.data import PatchSampler, synthesize_volume
    from tpuseg_torch.models import build_model
    from tpuseg_torch.train import create_train_state, make_train_step

    cfg = _dp_config()
    vols = [synthesize_volume(shape=(64, 128, 128), num_instances=16, seed=s)
            for s in (0, 1)]
    sampler = PatchSampler(vols, patch_size=cfg.data.patch_size,
                           batch_size=cfg.data.batch_size,
                           max_instances=cfg.data.max_instances, seed=SEED)
    batches = [sampler.next_batch() for _ in range(MP_DP_STEPS)]
    np.savez(os.path.join(tmp, "dp_batches.npz"),
             **{f"{i:02d}_{k}": v for i, b in enumerate(batches)
                for k, v in b.items()})
    init = build_model(cfg.model, seed=SEED).state_dict()
    torch.save(init, os.path.join(tmp, "dp_init.pt"))

    model = build_model(cfg.model)
    model.load_state_dict(init)
    model.cuda().train()
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    single, single_ms = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, {k: torch.from_numpy(v).cuda() for k, v in b.items()},
                 1)
        single.append(float(m["loss"]))
        torch.cuda.synchronize()
        single_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            norm1 = float(m["grad_norm"])
            step1 = {k: v.detach().cpu().clone() for k, v in
                     model.state_dict().items()}
    del model, state, step
    want, want_norm = _f32_first_step(tmp, dp=False)
    torch.cuda.empty_cache()

    run_group([os.path.abspath(__file__), "--worker", "dp", tmp], 2, tmp,
              backend="gloo")
    recs = _worker_records("dp", tmp, 2)
    _sum_launches(acc, recs)
    for i in range(MP_DP_STEPS):
        a, b = (r["steps"][i] for r in recs)
        if a["digest"] != b["digest"] or a["loss"] != b["loss"]:
            raise AssertionError(f"[16a] step {i + 1}: the ranks' states "
                                 "differ")
        if abs(a["loss"] - single[i]) > 0.01 * abs(single[i]):
            raise AssertionError(f"[16a] step {i + 1}: DP loss {a['loss']} "
                                 f"vs single-process {single[i]}")
    got = torch.load(os.path.join(tmp, "dp_step1.pt"), weights_only=True)
    worst = max(float((got[k] - step1[k]).abs().max()) for k in step1
                if k.endswith(("weight", "bias")))
    # Adam's first update moves each element by +-lr whatever the gradient's
    # size, so the parameters bound only its signs; the gradient's norm and,
    # in float32, the averaged gradient itself are held to the single-process
    # step's (in bf16 the rounding hides a BatchNorm backward left unsynced)
    norm_err = abs(recs[0]["steps"][0]["grad_norm"] - norm1) / norm1
    grads = torch.load(os.path.join(tmp, "dp_grads1_f32.pt"),
                       weights_only=True)
    grad_err = float((grads - want).norm() / want.norm())
    print(f"[16a] step 1: parameters within {worst / cfg.train.lr:.3f} lr "
          f"(bound 2.5); gradient norm {recs[0]['steps'][0]['grad_norm']:.6f}"
          f" vs {norm1:.6f}, relative {norm_err:.2e} (bound "
          f"{MP_DP_NORM_RTOL}); in float32 the averaged gradient "
          f"{grad_err:.3e} from the single-process step's in relative L2 "
          f"(bound {MP_DP_GRAD_RTOL}), norms {recs[0]['f32_grad_norm']:.6f} "
          f"vs {want_norm:.6f}", flush=True)
    if worst >= 2.5 * cfg.train.lr:
        raise AssertionError(f"[16a] step 1: a parameter {worst:.2e} from "
                             "the single-process step (bound 2.5 lr)")
    if norm_err >= MP_DP_NORM_RTOL or grad_err >= MP_DP_GRAD_RTOL:
        raise AssertionError(f"[16a] step 1: gradient norm {norm_err:.2e} "
                             "from the single-process step's, float32 "
                             f"gradient {grad_err:.3e} (relative L2)")
    for r, rec in enumerate(recs):
        if rec["launches"]["conv3x3_raw"] != 11 * MP_DP_STEPS:
            raise AssertionError(f"[16a] rank {r}: K6 launched "
                                 f"{rec['launches']['conv3x3_raw']} times, "
                                 f"want 11 x {MP_DP_STEPS}")
        warm = rec["steps"][1:]
        ms = float(np.median([s["ms"] for s in warm]))
        grad = float(np.median([s["grad_ms"] for s in warm]))
        bn = float(np.median([s["bn_ms"] for s in warm]))
        print(f"[16a] rank {r} ({rec['device']}, backend {rec['backend']}): "
              f"{MP_DP_STEPS} DP steps of 4 + 4 examples, bf16, fused; step "
              f"ms {[round(s['ms'], 1) for s in rec['steps']]}, warm median "
              f"{ms:.1f} ms, of which the gradient all-reduce {grad:.1f} ms "
              f"({100 * grad / ms:.1f}%) and the BatchNorm statistics' "
              f"{bn:.1f} ms ({100 * bn / ms:.1f}%); K6 "
              f"{rec['launches']['conv3x3_raw']} launches "
              f"({rec['mma_launches']['conv3x3_raw']} on the tensor cores); "
              f"peak device memory {rec['peak_gb']:.2f} GB", flush=True)
    print(f"[16a] states bitwise equal on both ranks after each step; losses "
          f"{[round(s['loss'], 5) for s in recs[0]['steps']]} vs "
          f"single-process {[round(x, 5) for x in single]} (within 1%); "
          f"single-process step ms "
          f"{[round(x, 1) for x in single_ms]}")
    return os.path.join(tmp, "dp_init.pt")


def phase_mp_train_cli(tmp: str) -> None:
    """(b) ``cli.train`` as 2 processes (gloo, both on ``cuda:0``) under
    (a)'s configuration: 10 steps, then ``--resume`` to 20."""
    ck = os.path.join(tmp, "mp_ckpt")
    log = os.path.join(tmp, "mp_train.jsonl")
    argv = ["-m", "tpuseg_torch.cli.train", "--synthetic", "2", "--log", log,
            "--set", 'train.apply_impl="fused"', "--set", "train.lr=0.001",
            "--set", "train.warmup_steps=1", "--set", "train.log_every=5",
            "--set", "train.ckpt_every=10",
            "--set", f"train.ckpt_dir={json.dumps(ck)}"]
    t0 = time.perf_counter()
    outs = run_group(argv + ["--set", "train.total_steps=10"], 2, tmp,
                     backend="gloo")
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_group(argv + ["--resume", "--set", "train.total_steps=20"], 2, tmp,
              backend="gloo")
    second = time.perf_counter() - t0
    recs = _read_jsonl(log)
    entries = sorted(os.listdir(ck))
    if [r["step"] for r in recs] != [5, 10, 15, 20] or entries != [
            "10", "20", "config.json"]:
        raise AssertionError(f"[16b] log steps {[r['step'] for r in recs]}, "
                             f"checkpoint directory {entries}")
    for r, out in enumerate(outs):
        if f"process {r}/2 on cuda:0, backend gloo" not in out:
            raise AssertionError(f"[16b] process {r} printed no runtime line")
    print(f"[16b] cli.train in 2 processes (gloo, cuda:0): 10 steps "
          f"({first:.1f} s incl. start-up), --resume 10 -> 20 ({second:.1f} "
          f"s); one writer: log steps {[r['step'] for r in recs]}, losses "
          f"{[round(r['loss'], 4) for r in recs]}, Mvox/s "
          f"{[round(r['mvox_per_s'], 3) for r in recs]}, checkpoint "
          f"directory {entries}")


def _infer_argv(ckpt_dir, vol_path, ann_path, out, extra):
    return ["--checkpoint", ckpt_dir, "--input", vol_path, "--output", out,
            "--calibrate-from", ann_path, "--validate", "--set",
            'infer.apply_impl="fused"', *extra]


def phase_mp_infer(sv, ckpt_dir: str, vol_path: str, ann_path: str,
                   tmp: str, acc: dict) -> np.ndarray:
    """(c) ``cli.infer --shard z2`` and (d) ``--stream 48 --stream-shard 2``
    (with ``nms_impl="pallas"``) in 2 processes on gloo, one shard each,
    against the single-process calls with the same flags."""
    from tpuseg_torch.core import Config
    from tpuseg_torch.infer.tiles import tile_grid

    legs = {"shard": ("--shard", "z2"),
            "stream": ("--stream", str(MP_STREAM_CHUNK), "--stream-shard",
                       "2", "--set", 'postproc.nms_impl="pallas"')}
    single, runs = {}, {}
    for tag, extra in legs.items():
        out = os.path.join(tmp, f"mp_single_{tag}.npy")
        wall, _, labels, peak, launches, _ = _cli_labels(
            _infer_argv(ckpt_dir, vol_path, ann_path, out, extra),
            f"single-process {tag}")
        single[tag] = (labels, wall, peak, launches)
        runs[tag] = _infer_argv(ckpt_dir, vol_path, ann_path,
                                os.path.join(tmp, f"mp_two_{tag}.npy"), extra)
    with open(os.path.join(tmp, "cli_runs.json"), "w") as f:
        json.dump(runs, f)
    torch.cuda.empty_cache()
    run_group([os.path.abspath(__file__), "--worker", "cli", tmp], 2, tmp,
              backend="gloo")
    recs = _worker_records("cli", tmp, 2)
    _sum_launches(acc, [r[t] for r in recs for t in legs])
    cfg = Config()
    D, H, W = MAIN_SHAPE
    halo = cfg.infer.shard_halo
    n_chunks = -(-D // MP_STREAM_CHUNK)
    # (K1, K5, K4) a process: (d)'s seeds come from K5 (nms_impl="pallas")
    want = {"shard": (1, 0, 3 * len(tile_grid((D // 2 + 2 * halo, H, W),
                                              cfg.infer.tile))),
            "stream": (0, n_chunks, 3 * len(tile_grid(
                (MP_STREAM_CHUNK + 2 * halo, H // 2 + 2 * halo, W),
                cfg.infer.tile)) * n_chunks * 2)}
    for tag in legs:
        labels, wall, peak, launches = single[tag]
        got = np.load(runs[tag][runs[tag].index("--output") + 1])
        same = np.array_equal(got, labels)
        m = f1_iou50_on_card(got, sv.labels)
        print(f"[16{'c' if tag == 'shard' else 'd'}] cli.infer "
              f"{' '.join(legs[tag][:4])} in 2 processes (gloo, one shard "
              f"each) {'==' if same else '!='} the single-process call "
              f"elementwise; {m['n_pred']} instances, F1@IoU0.5 "
              f"{m['f1']:.4f}; single-process wall {wall:.3f} s, peak "
              f"{peak:.2f} GB", flush=True)
        if not same:
            raise AssertionError(f"[16] {tag}: 2 processes != 1 on "
                                 f"{int((got != labels).sum())} voxels")
        for r, rec in enumerate(recs):
            run = rec[tag]
            k1, k5, k4 = (run["launches"][k] for k in (
                "seed_chase_pass", "fused_peak_nms", "fused_convblock"))
            print(f"       process {r}: status {run['status']}, wall "
                  f"{run['wall']:.3f} s, peak {run['peak_gb']:.2f} GB; "
                  f"launches {run['launches']}, K4 on the tensor cores "
                  f"{run['mma_launches']['fused_convblock']}")
            if run["status"] != 0 or ("connectivity validation: OK" in
                                      run["printed"]) != (r == 0):
                raise AssertionError(f"[16] {tag}: process {r} status "
                                     f"{run['status']} or its validation "
                                     "line")
            if (k1, k5, k4) != want[tag] or run["mma_launches"][
                    "fused_convblock"] != k4:
                raise AssertionError(f"[16] {tag}: process {r} K1 {k1}, K5 "
                                     f"{k5}, K4 {k4} (want {want[tag]}, all "
                                     "K4 on the tensor cores)")
    return single["shard"][0]


def phase_mp_nccl(ckpt_dir: str, vol_path: str, ann_path: str, tmp: str,
                  shard_labels: np.ndarray, acc: dict) -> None:
    """(e) NCCL on a group of one: (a)'s DP step through the group ==
    the step without it, bitwise; ``--shard z2`` through the backend's
    collectives == the labels without a group."""
    with open(os.path.join(tmp, "cli_runs.json"), "w") as f:
        json.dump({"shard": _infer_argv(
            ckpt_dir, vol_path, ann_path,
            os.path.join(tmp, "mp_nccl_shard.npy"), ("--shard", "z2"))}, f)
    run_group([os.path.abspath(__file__), "--worker", "nccl", tmp], 1, tmp)
    (rec,) = _worker_records("nccl", tmp, 1)
    _sum_launches(acc, [rec["shard"]])
    same = np.array_equal(np.load(os.path.join(tmp, "mp_nccl_shard.npy")),
                          shard_labels)
    equal = rec["digests"][0] == rec["digests"][1]
    print(f"[16e] world size 1, backend {rec['backend']}: DP step through "
          f"the group {'==' if equal else '!='} the step without one, "
          f"bitwise (loss {rec['losses'][0]:.6f} / {rec['losses'][1]:.6f}); "
          f"cli.infer --shard z2 "
          f"{'==' if same else '!='} the labels without a group (wall "
          f"{rec['shard']['wall']:.3f} s)")
    if rec["backend"] != "nccl" or not equal or not same \
            or rec["shard"]["status"] != 0:
        raise AssertionError("[16e] NCCL at world size 1 differs from no "
                             "group")


def phase_multiprocess(sv, ckpt_dir: str, vol_path: str, ann_path: str,
                       tmp: str) -> dict:
    """Phase 16: the multi-process runtime, every process on ``cuda:0``
    (runs after phase 9, with its checkpoint). NCCL refuses two ranks on
    one device, so the two-process legs run gloo (``TPUSEG_DIST_BACKEND``)
    and NCCL is checked at world size 1. Returns every kernel's launches
    summed over the worker processes."""
    acc = {}
    torch.cuda.empty_cache()
    phase_mp_dp(tmp, acc)
    phase_mp_train_cli(tmp)
    shard_labels = phase_mp_infer(sv, ckpt_dir, vol_path, ann_path, tmp, acc)
    phase_mp_nccl(ckpt_dir, vol_path, ann_path, tmp, shard_labels, acc)
    # every kernel of a Pallas kernel; of the histograms, H3 counts labels
    # for the one-volume filter only (the sharded paths compact packed ids);
    # M1/M2 run with the saddle merge, which these legs leave off (phase 19
    # holds them on the merge-on calls)
    missing = [k for k in KERNELS if k not in ("label_counts",) + PAIR_KERNELS
               and not acc.get(k)]
    if missing:
        raise AssertionError(f"[16] the multi-process paths never launched "
                             f"{missing}: {acc}")
    return acc


# ---------------------------------------------------------------- phase 17

def center_f1_on_card(pred: np.ndarray, gt: np.ndarray) -> dict:
    """``instance_metrics(pred, gt, criterion="center")`` on the card: a GT
    instance is hit when the predicted instance at its rounded centroid
    (half to even, as ``np.round``) is positive and not yet claimed, so
    ``tp`` is the number of distinct positive ids at the GT centroids. The
    coordinate sums are integers below 2**53, exact in float64 in any
    order."""
    p = torch.from_numpy(np.asarray(pred)).cuda()
    g = torch.from_numpy(np.asarray(gt)).cuda().reshape(-1)
    ids, inv = torch.unique(g, return_inverse=True)
    counts = torch.bincount(inv, minlength=ids.numel()).double()
    lin = torch.arange(g.numel(), device=g.device)
    hw, w = p.shape[1] * p.shape[2], p.shape[2]
    cen = torch.stack([torch.bincount(inv, weights=c.double(),
                                      minlength=ids.numel())
                       for c in (lin // hw, (lin % hw) // w, lin % w)], 1)
    del lin
    cen = torch.round(cen[ids > 0] / counts[ids > 0, None]).long()
    hit = p[cen[:, 0], cen[:, 1], cen[:, 2]]
    tp = int(torch.unique(hit[hit > 0]).numel())
    n_pred = int((torch.unique(p) > 0).sum())
    n_gt = int((ids > 0).sum())
    del p, g, inv
    torch.cuda.empty_cache()
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_gt if n_gt else 0.0
    f1 = 2 * precision * recall / (precision + recall) if tp else 0.0
    return {"f1": f1, "recall": recall, "tp": tp, "n_pred": n_pred,
            "n_gt": n_gt}


def c5_configs(fixtures: dict):
    """bench.py's c3 configuration (``C3_SETS``) and, per c5 fixture, c3
    calibrated from the fixture's annotations as bench.py:372-378 does: the
    volume-matched fg fraction and the per-axis NMS radius."""
    import dataclasses

    from tpuseg_torch.core import Config
    from tpuseg_torch.ops.calibrate import (expected_fg_fraction,
                                            nms_radius_from_half_sizes)

    c3 = Config().override(**C3_SETS)
    return c3, {name: dataclasses.replace(c3, postproc=dataclasses.replace(
        c3.postproc,
        fg_target_fraction=expected_fg_fraction(tv.half_sizes, tv.image.size),
        nms_radius=nms_radius_from_half_sizes(tv.half_sizes)))
        for name, tv in fixtures.items()}


def phase_touching_quality(model, fixtures: dict, vols, cfgs: dict) -> dict:
    """(a) Each c5 fixture through ``make_infer_fn`` under its calibrated
    c3 configuration: F1@IoU0.5, centre F1 and recall beside the JAX
    package's record; touch60_snr20 must reach F1@IoU0.5 0.5."""
    from tpuseg_torch.infer import make_infer_fn

    labels = {}
    for i, (name, tv) in enumerate(fixtures.items()):
        t0 = time.perf_counter()
        labels[name] = make_infer_fn(model, cfgs[name])(vols[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = f1_iou50_on_card(labels[name].cpu().numpy(), tv.labels)
        c = center_f1_on_card(labels[name].cpu().numpy(), tv.labels)
        jf1, jcf1, jrec = C5_JAX[name]
        print(f"[17] {name}: nms_radius {tuple(cfgs[name].postproc.nms_radius)}"
              f", {m['n_pred']} instances vs {m['n_gt']} GT, F1@IoU0.5 "
              f"{m['f1']:.4f}, f1_center {c['f1']:.4f}, recall_center "
              f"{c['recall']:.4f} (wall {wall:.3f} s) | the JAX package on "
              f"a TPU (BENCH_r05.json): F1@IoU0.5 {jf1}, f1_center {jcf1}"
              + (f", recall_center {jrec}" if jrec is not None else ""),
              flush=True)
        if name == "touch60_snr20" and m["f1"] < 0.5:
            raise AssertionError(f"[17] {name}: calibrated F1@IoU0.5 "
                                 f"{m['f1']:.4f} < 0.5")
    return labels


def phase_touching_batched(model, vols, cfg) -> None:
    """(b) The five fixtures through ``make_batched_infer_fn`` under one
    configuration (touch60_snr20's calibrated c3) == ``make_infer_fn`` on
    each volume, elementwise; wall times in turns (batched, the five single
    calls, batched)."""
    from tpuseg_torch.infer import make_batched_infer_fn, make_infer_fn
    from tpuseg_torch.utils import hard_sync

    single, batched = make_infer_fn(model, cfg), make_batched_infer_fn(
        model, cfg)
    walls = {"batched": [], "single": []}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hard_sync(fn())
        walls[tag].append(time.perf_counter() - t0)
        return out

    got = timed("batched", lambda: batched(vols))
    want = timed("single", lambda: [single(v) for v in vols])
    timed("batched", lambda: batched(vols))
    for i, w in enumerate(want):
        if not torch.equal(got[i], w):
            raise AssertionError(f"[17] batched labels of volume {i} != "
                                 f"make_infer_fn's on {int((got[i] != w).sum())}"
                                 " voxels")
    n = len(vols)
    print(f"[17] make_batched_infer_fn on ({n}, {', '.join(map(str, MAIN_SHAPE))})"
          f" == make_infer_fn per volume elementwise; wall: batched "
          f"{walls['batched'][0]:.3f} / {walls['batched'][1]:.3f} s, the {n} "
          f"single calls {walls['single'][0]:.3f} s in all", flush=True)


def phase_touching_export(model, ckpt_dir: str, vol, cfg, labels,
                          tmp: str) -> None:
    """(e) ``cli.export`` of the checkpoint to a ``.pth``, loaded back into
    the port: the labels of a fixture equal the checkpoint's."""
    from tpuseg_torch.cli import export as cli_export
    from tpuseg_torch.cli.common import load_model_state
    from tpuseg_torch.infer import make_infer_fn
    from tpuseg_torch.models import build_model

    out = os.path.join(tmp, "exported.pth")
    cli_export.main(["--checkpoint", ckpt_dir, "--output", out])
    again = build_model(cfg.model)
    again.load_state_dict(load_model_state(out))
    got = make_infer_fn(again.to(vol.device), cfg)(vol)
    if not torch.equal(got, labels):
        raise AssertionError("[17] the exported .pth gives other labels on "
                             f"{int((got != labels).sum())} voxels")
    print("[17] cli.export -> .pth -> the port: labels equal the "
          "checkpoint's", flush=True)


def phase_touching_variant(vol_path: str, tmp: str) -> None:
    """(g) ``cli.train`` and ``cli.infer`` with ``model.norm="group"``,
    ``model.activation="gelu"`` at full width (the plain applies; K1-K3 in
    the post-processing)."""
    from tpuseg_torch.cli import infer as cli_infer
    from tpuseg_torch.cli import train as cli_train

    ck = os.path.join(tmp, "variant_ckpt")
    sets = ["--set", 'model.norm="group"', "--set", 'model.activation="gelu"']
    t0 = time.perf_counter()
    cli_train.main(["--synthetic", "1", *sets, "--set",
                    f"train.total_steps={VARIANT_STEPS}", "--set",
                    "train.ckpt_dir=" + json.dumps(ck)])
    t_train = time.perf_counter() - t0
    out = os.path.join(tmp, "variant_labels.npy")
    before = _launches()
    t0 = time.perf_counter()
    status = cli_infer.main(["--checkpoint", ck, "--input", vol_path,
                             "--output", out, "--report-convergence", *sets])
    t_infer = time.perf_counter() - t0
    ran = {k: _launches()[k] - before[k] for k in before}
    labels = np.load(out)
    print(f"[17] group norm + GELU: cli.train {VARIANT_STEPS} steps "
          f"({t_train:.1f} s incl. set-up), cli.infer status {status}, "
          f"{int(labels.max())} instances ({t_infer:.1f} s incl. set-up); "
          f"kernel launches of the inference {ran}", flush=True)
    if status not in (0, 4) or labels.shape != MAIN_SHAPE:
        raise AssertionError(f"[17] variant cli.infer: status {status}, "
                             f"labels {labels.shape}")
    missing = [k for k in INFER_KERNELS if ran[k] == 0]
    if missing or ran["fused_convblock"]:
        raise AssertionError(f"[17] variant inference launched {ran}")


def phase_touching_checks(model, fixtures: dict, vols, cfgs: dict,
                          labels: dict, tmp: str) -> None:
    """(c) K1-K3 against their twins on the trained probabilities of
    touch60_snr20 (``compare_kernels``; then the watershed at its
    calibrated thresholds, and K5 in ``seed_labels_from_peaks``, against
    the plain versions); (d) its labels and ground truth through
    ``python -m tpuseg_torch.cli.evaluate`` (the IoU and the centre
    criterion, two processes) == the in-process ``instance_metrics`` +
    ``voxel_metrics``, and the card's F1 helpers == both; (f)
    ``measure_rf_radius`` of the trained net, in bf16 and in float32."""
    import dataclasses
    import subprocess
    import sys

    from tpuseg_torch.eval import instance_metrics, voxel_metrics
    from tpuseg_torch.infer import (make_infer_stages, measure_rf_radius,
                                    rf_radius_bound)
    from tpuseg_torch.models import build_model
    from tpuseg_torch.ops import seed_labels_from_peaks, watershed
    from tpuseg_torch.ops.calibrate import threshold_for_fraction

    name = "touch60_snr20"
    tv, cfg = fixtures[name], cfgs[name]
    pred = labels[name].cpu().numpy()
    paths = [os.path.join(tmp, f) for f in ("c5_pred.npy", "c5_gt.npy")]
    np.save(paths[0], pred)
    np.save(paths[1], tv.labels)
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpuseg_torch.cli.evaluate", "--pred", paths[0],
         "--gt", paths[1], *extra], cwd=here, stdout=subprocess.PIPE,
        text=True) for extra in ([], ["--criterion", "center"])]
    try:
        logits = make_infer_stages(model, cfg)[1](vols[0])
        fg, pk = (torch.sigmoid(logits[k]).float()
                  for k in ("fg_logits", "peak_logits"))
        del logits
        recs = compare_kernels(fg, pk, timed=False)
        pp = cfg.postproc
        thr = float(threshold_for_fraction(
            fg, pp.fg_target_fraction,
            sample_stride=cfg.data.normalize_sample_stride))
        kw = dict(peak_threshold=pp.peak_threshold, fg_threshold=thr,
                  peak_radius=pp.nms_radius, flood_iters=pp.flood_iters)
        ws = watershed(fg, pk, **kw)
        if not torch.equal(ws, watershed(fg, pk, plain=True, **kw)):
            raise AssertionError("[17] calibrated watershed: kernels != twins")
        seeds = seed_labels_from_peaks(pk, pp.peak_threshold, pp.nms_radius,
                                       nms_impl="pallas")
        if not torch.equal(seeds, seed_labels_from_peaks(
                pk, pp.peak_threshold, pp.nms_radius)):
            raise AssertionError("[17] seed labels: K5 != plain NMS")
        del fg, pk, ws, seeds
        print(f"[17] {name}, trained probabilities: {', '.join(recs)} == "
              f"their twins elementwise; the watershed at the calibrated threshold {thr:.4f} and "
              f"radius {tuple(pp.nms_radius)} == its plain run; "
              f"seed_labels_from_peaks with K5 == with the plain NMS",
              flush=True)
        m = instance_metrics(pred, tv.labels)
        m.update(voxel_metrics(pred, tv.labels))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"[17] cli.evaluate exited "
                             f"{[p.returncode for p in procs]}")
    got, center = (json.loads(o) for o in outs)
    if got != m:
        raise AssertionError(f"[17] cli.evaluate {got} != in-process {m}")
    card, card_c = (f(pred, tv.labels) for f in (f1_iou50_on_card,
                                                  center_f1_on_card))
    if (card["tp"], card["n_pred"], card["n_gt"]) != (m["tp"], m["n_pred"],
                                                      m["n_gt"]) or \
            (card_c["tp"], card_c["n_pred"]) != (center["tp"],
                                                 center["n_pred"]):
        raise AssertionError(f"[17] the card's F1 helpers {card} {card_c} != "
                             f"instance_metrics {m} {center}")
    print(f"[17] cli.evaluate JSON == in-process instance_metrics + "
          f"voxel_metrics (F1@IoU0.5 {m['f1']:.4f}, voxel_dice "
          f"{m['voxel_dice']:.4f}); centre criterion {center['f1']:.4f}; the "
          f"card's F1 helpers agree with both", flush=True)
    # the trained net as it runs (bf16), and its weights in float32
    f32 = build_model(dataclasses.replace(model.config,
                                          compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    f32.to(next(model.parameters()).device)
    levels = len(model.config.features)
    bound_rf = 8 * 2 ** (levels - 1) - 4
    t0 = time.perf_counter()
    rf = {dt: measure_rf_radius(m, probe_size=RF_PROBE)
          for dt, m in (("bf16", model), ("float32", f32))}
    print(f"[17] measured receptive-field radius of the trained "
          f"{levels}-level net: {rf['bf16']} in bf16, {rf['float32']} in "
          f"float32 (probe {RF_PROBE}^3, {time.perf_counter() - t0:.1f} s; "
          f"recorded for the JAX package: {rf_radius_bound(levels)}; "
          f"analytic bound {bound_rf}; infer.shard_halo default 32)",
          flush=True)
    if not all(0 < r <= min(bound_rf, RF_PROBE // 2 - 1)
               for r in rf.values()):
        raise AssertionError(f"[17] receptive-field radius {rf} outside "
                             "(0, the analytic bound]")


def phase_touching(ckpt_dir: str, tmp: str) -> dict:
    """Phase 17: bench.py's c5 fixtures and the evaluation surface on the
    port, with phase 9's checkpoint. Returns the launches of the main-path
    legs (a), (b), (e) and (g) ((c), (d) and (f) run after the count is
    read) and the fixtures, which phase 18 takes over."""
    from tpuseg_torch.data import synthesize_touching_volume

    t0 = time.perf_counter()
    fixtures = {name: synthesize_touching_volume(**C5_KW, **kw)
                for name, kw in C5_FIXTURES.items()}
    print(f"[17] synthesized the five c5 fixtures {MAIN_SHAPE} in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {int(tv.labels.max())} nuclei"
                      for n, tv in fixtures.items()), flush=True)
    c3, cfgs = c5_configs(fixtures)
    model = trained_model(ckpt_dir, c3)
    vols = torch.stack([torch.from_numpy(tv.image)
                        for tv in fixtures.values()]).cuda()
    vol_path = os.path.join(tmp, "c5_touch60_snr20.npy")
    np.save(vol_path, fixtures["touch60_snr20"].image)
    _reset_launches()
    labels = phase_touching_quality(model, fixtures, vols, cfgs)
    phase_touching_batched(model, vols, cfgs["touch60_snr20"])
    phase_touching_export(model, ckpt_dir, vols[0], cfgs["touch60_snr20"],
                          labels["touch60_snr20"], tmp)
    phase_touching_variant(vol_path, tmp)
    launches = _launches()
    missing = [k for k in TOUCHING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[17] the touching legs never launched "
                             f"{missing}: {launches}")
    phase_touching_checks(model, fixtures, vols, cfgs, labels, tmp)
    del vols
    torch.cuda.empty_cache()
    return launches, fixtures



def check_block(name, got, want, dtype) -> float:
    """Max abs error of the K4 kernel against its twin; raises beyond the
    bounds.

    float32 (TF32 off in the twin): every element within 1e-4 of the
    output's max magnitude (summation order only; T is not rounded).
    bfloat16: kernel and twin sum conv1 in different orders, so now and then
    a T element rounds to the neighbouring bf16 value, and conv2 carries
    that ulp(T) * |w2| to every output in reach — more than 2 ulps of an
    output near zero. So: every element within 2 bf16 ulps of the output's
    max magnitude, and at least 99.5% of the elements within 2 ulps of
    their own magnitude (floored at 2^-8 of the max, as ``check_conv``)."""
    err = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    max_err = float(err.max())
    if dtype == torch.float32:
        ok, frac = max_err <= 1e-4 * top, 1.0
    else:
        floor = torch.clamp(want.float().abs(), min=top * 2.0 ** -8)
        frac = float((err <= 2 * bf16_ulp(floor)).float().mean())
        ok = (frac >= 0.995
              and max_err <= 2 * float(bf16_ulp(torch.tensor(top))))
    if not ok:
        raise AssertionError(f"{name}: kernel != twin (max abs err "
                             f"{max_err:.3g}, max |y| {top:.3g}, within 2 "
                             f"ulps {frac:.5f})")
    return max_err


def phase_convblock():
    """K4 against its twin, f32 and bf16, at the fused sweep's three block
    shapes, a ragged one and two edge shapes (one plane; more than one z
    chunk with ragged rows and columns), with non-zero affines (a non-zero
    b1 shows a T that is not zero outside the volume); which kernel ran (the
    wrapper's counters); times in bf16 at the block shapes: the kernel
    (weights re-laid once, as the main path calls it), the twin, and the
    library call — the module ConvBlock in eval mode."""
    from tpuseg_torch.models.blocks import ConvBlock
    from tpuseg_torch.ops.convblock import (block_bodies, fused_convblock,
                                            fused_convblock_plain,
                                            kernel_weights)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g)

    worst, times = 0.0, {}
    for shape in (BLOCK_SHAPE, RAGGED_BLOCK_SHAPE) + EDGE_BLOCK_SHAPES:
        n, sp = shape[0], shape[1:]
        for ci in BLOCK_CI:
            w1 = randn(32, ci, 3, 3, 3) / (27 * ci) ** 0.5
            w2 = randn(32, 32, 3, 3, 3) / (27 * 32) ** 0.5
            s1, s2 = (0.5 + torch.rand(32, device="cuda", generator=g)
                      for _ in range(2))
            b1, b2 = 0.5 * randn(32), 0.5 * randn(32)
            x32 = randn(n, ci, *sp)
            for name in ("float32", "bfloat16"):
                dtype = getattr(torch, name)
                x = x32.to(dtype)
                before = fused_convblock.mma_launches
                got = fused_convblock(x, w1, s1, b1, w2, s2, b2, name)
                want = fused_convblock_plain(x, w1, s1, b1, w2, s2, b2, name)
                torch.cuda.synchronize()
                ran_mma = fused_convblock.mma_launches - before
                if ran_mma != int(dtype == torch.bfloat16):
                    raise AssertionError(
                        f"fused_convblock ci={ci} {name}: tensor-core kernel "
                        f"launched {ran_mma} times")
                worst = max(worst, check_block(
                    f"fused_convblock ci={ci} {tuple(shape)} {name}", got,
                    want, dtype))
                del got, want
                if shape != BLOCK_SHAPE or dtype != torch.bfloat16:
                    continue
                bodies = block_bodies(dtype, ci)
                w1k = kernel_weights(w1, name, bodies[0])
                w2k = kernel_weights(w2, name, bodies[1])
                block = ConvBlock(ci, 32).cuda().eval()
                with torch.no_grad():
                    block.conv0.weight.copy_(w1)
                    block.conv1.weight.copy_(w2)
                    for norm, s, b in ((block.norm0, s1, b1),
                                       (block.norm1, s2, b2)):
                        norm.weight.copy_(s)
                        norm.bias.copy_(b)

                    times[ci] = (
                        cuda_ms(lambda: fused_convblock(
                            x, w1k, s1, b1, w2k, s2, b2, name), 3),
                        cuda_ms(lambda: fused_convblock_plain(
                            x, w1, s1, b1, w2, s2, b2, name), 3),
                        cuda_ms(lambda: block(x), 5), bodies)
            del x32
    vox = int(np.prod(BLOCK_SHAPE))
    records = {}
    for ci, (ms, plain_ms, lib_ms, bodies) in times.items():
        # 2*27*32*(ci + 32) FLOP per voxel on the tensor cores' rate; x and
        # the output in bf16, the weights and affines in f32
        records[ci] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "body": f"conv1 {bodies[0]}, conv2 {bodies[1]}",
            **bound((ci + 32) * vox * 2 + 27 * 32 * (ci + 32) * 4 + 4 * 32 * 4,
                    2 * 27 * 32 * (ci + 32) * vox, BF16_FLOPS)}
        flop = 2 * 27 * 32 * (ci + 32) * vox
        print(f"[10] fused_convblock ci={ci} {BLOCK_SHAPE} bf16, conv1 "
              f"{bodies[0]}, conv2 {bodies[1]}: kernel {ms:.3f} ms "
              f"({flop / ms / 1e9:.1f} TFLOP/s), twin {plain_ms:.3f} ms, "
              f"library ConvBlock {lib_ms:.3f} ms (ratio {ms / lib_ms:.2f}), "
              f"bound {records[ci]['bound_ms']:.3f} ms by "
              f"{records[ci]['bound_by']}")
    tile_ms = sum(t[0] for t in times.values())
    tile_lib = sum(t[2] for t in times.values())
    print(f"[10] fused_convblock == twin (f32 and bf16) at {BLOCK_SHAPE}, "
          f"{RAGGED_BLOCK_SHAPE} and {EDGE_BLOCK_SHAPES}, ci in {BLOCK_CI}; "
          f"bf16 ran the tensor-core kernel, f32 never; max abs err "
          f"{worst:.3g}; one tile's three blocks {tile_ms:.3f} ms against the "
          f"library's {tile_lib:.3f} ms (ratio {tile_ms / tile_lib:.2f})")
    # the record: the up0.block shape (ci = 64), the largest of the three
    return {"max_abs_err": worst, "shape": [1, 64, *BLOCK_SHAPE[1:]],
            **records[64]}


def pool_nms(peak, threshold: float, radius):
    """The library call timed beside K5: ``F.max_pool3d`` local maxima at or
    above the threshold, without the index tie-break on plateaus (float
    pools cannot hold the indices) — timing only, used nowhere in the port."""
    k = tuple(2 * r + 1 for r in radius)
    mx = torch.nn.functional.max_pool3d(peak[None, None], k, stride=1,
                                        padding=tuple(radius))[0, 0]
    return (peak >= threshold) & (peak >= mx)


def phase_nms(image: np.ndarray):
    """K5 against its twin, elementwise, at the main-path shape and a ragged
    one with a per-axis radius, plateaus included; times at the main-path
    shape."""
    from tpuseg_torch.data import synthesize_volume
    from tpuseg_torch.ops.nms import fused_peak_nms, fused_peak_nms_plain

    thr = 0.5
    _, pk = analytic_maps(image, "cuda")
    ragged = synthesize_volume(shape=RAGGED_SHAPE, num_instances=40,
                               seed=SEED + 1).image
    _, pk_r = analytic_maps(ragged, "cuda")
    cases = [("main", pk, (2, 2, 2)), ("ragged", pk_r, (1, 2, 2)),
             # quantized to 1/8: every blob top is a plateau of exact ties
             ("ragged plateaus", torch.round(pk_r * 8) / 8, (1, 2, 2)),
             ("ragged, radius 0 on z", pk_r, (0, 2, 1))]
    n_seeds = {}
    for tag, peak, radius in cases:
        before = fused_peak_nms.tile_launches
        got = fused_peak_nms(peak, thr, radius)
        want = fused_peak_nms_plain(peak, thr, radius)
        chain = fused_peak_nms(peak, thr, radius, body="chain")
        torch.cuda.synchronize()
        if fused_peak_nms.tile_launches - before != 1:
            raise AssertionError(f"fused_peak_nms ({tag}): radius {radius} "
                                 "did not take the tile pass")
        if got.dtype != torch.bool or not torch.equal(got, want):
            raise AssertionError(f"fused_peak_nms ({tag}): kernel != twin on "
                                 f"{int((got != want).sum())} voxels")
        if not torch.equal(chain, want):
            raise AssertionError(f"fused_peak_nms ({tag}): chain body != twin")
        n_seeds[tag] = int(got.sum())
    print(f"[11] {compare_tile_cases('nms')}")
    radius = cases[0][2]
    ms = cuda_ms(lambda: fused_peak_nms(pk, thr, radius), 10)
    chain_ms = cuda_ms(lambda: fused_peak_nms(pk, thr, radius, body="chain"),
                       10)
    plain_ms = cuda_ms(lambda: fused_peak_nms_plain(pk, thr, radius), 2)
    lib_ms = cuda_ms(lambda: pool_nms(pk, thr, radius), 5)
    # must read 4 B and write 1 B per voxel; about 40 compares per voxel
    # (two separable 5-wide pools on three axes and the candidate tests)
    rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "chain_ms": chain_ms,
           **bound(5 * pk.numel(), 40 * pk.numel(), F32_FLOPS)}
    print(f"[11] fused_peak_nms == twin elementwise: seeds {n_seeds}; at "
          f"{MAIN_SHAPE} kernel (one tile pass) {ms:.3f} ms, the chain in "
          f"this run {chain_ms:.3f} ms, twin {plain_ms:.3f} ms, "
          f"F.max_pool3d NMS (no tie-break) {lib_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}; earlier: "
          f"{EARLIER['fused_peak_nms']}")
    return rec


def _run_cli_infer(tmp, ckpt, vol_path, tag, *sets):
    """``cli.infer`` on the stack with ``--set`` overrides, the launch
    counts set to 0 just before and read just after; returns (labels,
    launches, status)."""
    from tpuseg_torch.cli import infer as cli_infer

    out_path = os.path.join(tmp, f"labels_{tag}.npy")
    argv = ["--checkpoint", ckpt, "--input", vol_path, "--output", out_path,
            "--report-convergence"]
    for kv in sets:
        argv += ["--set", kv]
    _reset_launches()
    status = cli_infer.main(argv)
    torch.cuda.synchronize()
    launches = _launches()
    if status not in (0, 4):
        raise AssertionError(f"cli.infer ({tag}) returned {status}")
    return np.load(out_path), launches, status


def profile_device_time(label: str, fn, top: int = 8, phase: int = 12) -> None:
    """Print where the device time of one warm ``fn()`` goes: the kernels by
    name, from ``torch.profiler`` (informational; a profiler that sees no
    device time prints "not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0) or 0
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    total = sum(kernels.values())
    if total == 0:
        print(f"[{phase}] profile of {label}: device time not measured")
        return
    # the host's wall time under the profiler is the profiler's own: the
    # busy share is this sum over the warm wall time printed above
    print(f"[{phase}] profile of {label}: device kernels {total:.1f} ms in all; "
          f"top {top} by device time:")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"       {ms:9.2f} ms {100 * ms / total:5.1f}%  {key[:90]}")


def phase_fused_main_path(image: np.ndarray, default_labels: np.ndarray,
                          tmp: str):
    """The main path under ``infer.apply_impl="fused"`` (K4), then under
    ``postproc.nms_impl="pallas"`` (K5) and ``postproc.method="flood"``, on
    the stack and the seeded checkpoint of phase 4."""
    from tpuseg_torch.ckpt import load_pth
    from tpuseg_torch.core import Config
    from tpuseg_torch.infer import make_infer_stages
    from tpuseg_torch.models import build_model

    cfg = Config()
    fused_cfg = cfg.override(**{"infer.apply_impl": "fused"})
    ckpt = os.path.join(tmp, "seeded.pth")
    vol_path = os.path.join(tmp, "volume.npy")
    write_seeded_checkpoint(ckpt, cfg.model)
    np.save(vol_path, image)

    labels, launches, status = _run_cli_infer(
        tmp, ckpt, vol_path, "fused", 'infer.apply_impl="fused"')
    k4_launches = launches["fused_convblock"]
    k4_mma = _mma_launches()["fused_convblock"]
    ids = np.unique(labels)
    print(f"[12] cli.infer, fused apply: status {status}, {ids.size - 1} "
          f"instances (plain apply: {int(default_labels.max())}); kernel "
          f"launches {launches}, {k4_mma} of K4's by the tensor-core kernel")
    if k4_launches != 3 * N_TILES or k4_mma != k4_launches:
        raise AssertionError(f"fused main path launched K4 {k4_launches} "
                             f"times ({k4_mma} on the tensor cores), not "
                             f"{3 * N_TILES}")
    missing = [k for k in INFER_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"fused main path never launched {missing}")
    if (labels.shape != MAIN_SHAPE or labels.dtype != np.int32
            or not np.array_equal(ids, np.arange(ids.size)) or ids.size < 2):
        raise AssertionError(f"fused main path: bad labels {labels.shape} "
                             f"{labels.dtype} ids {ids[:5]}...{ids[-5:]}")

    # warm stage times, plain and fused in turns
    model = build_model(cfg.model)
    model.load_state_dict(load_pth(ckpt))
    model.cuda()
    vol = torch.from_numpy(image).cuda()
    stages = {"plain": make_infer_stages(model, cfg),
              "fused": make_infer_stages(model, fused_cfg)}
    times = {"plain": [], "fused": []}
    logits = {}
    for tag in ("plain", "fused", "fused", "plain"):
        _, stage_net, stage_post = stages[tag]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[tag] = stage_net(vol)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stage_post(logits[tag])
        torch.cuda.synchronize()
        times[tag].append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))
    vox = int(np.prod(MAIN_SHAPE))
    for tag, runs in times.items():
        net, post = min(runs)
        print(f"[12] warm, {tag} apply: net sweep "
              f"{' / '.join(f'{r[0]:.1f}' for r in runs)} ms, post "
              f"{' / '.join(f'{r[1]:.1f}' for r in runs)} ms; best total "
              f"{net + post:.1f} ms ({vox / (net + post) / 1e3:.2f} Mvox/s)")

    for tag in ("plain", "fused"):
        profile_device_time(
            f"one warm {tag} call (sweep + post-processing)",
            lambda: stages[tag][2](stages[tag][1](vol)))

    # the fused sweep once more through K4's twin: the logits are bf16, and a
    # block output that rounds the other way (see check_block) moves on
    # through the mid net, so the bound is on the logits' scale: every voxel
    # within 0.1 of the largest |logit| and 99.5% within 0.02 of it
    twin = make_infer_stages(model, fused_cfg, plain=True)[1](vol)
    worst = {}
    for k, got in logits["fused"].items():
        want = twin[k]
        if got.shape != MAIN_SHAPE or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fused {k}: shape {tuple(got.shape)} or "
                                 "non-finite")
        err = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        frac = float((err <= 0.02 * top).float().mean())
        worst[k] = (float(err.max()), float(err.mean()), top, frac)
        if float(err.max()) > 0.1 * top or frac < 0.995:
            raise AssertionError(f"fused {k}: kernel != twin sweep: {worst[k]}")
    print(f"[12] fused logits, K4 vs its twin over the whole sweep (max abs "
          f"err, mean abs err, max |logit|, share within 2% of it): {worst}")
    plain_diff = {k: float((logits["fused"][k].float()
                            - logits["plain"][k].float()).abs().mean())
                  for k in logits["fused"]}
    print(f"[12] fused vs plain-module logits, mean abs difference: "
          f"{plain_diff}")

    labels, launches, status = _run_cli_infer(
        tmp, ckpt, vol_path, "nms", 'postproc.nms_impl="pallas"')
    print(f"[12] cli.infer, nms_impl=pallas: status {status}, "
          f"{int(labels.max())} instances; kernel launches {launches}")
    k5_tiles = _tile_launches()["fused_peak_nms"]
    if launches["fused_peak_nms"] == 0 or k5_tiles != launches["fused_peak_nms"]:
        raise AssertionError(f"nms_impl='pallas' launched K5 "
                             f"{launches['fused_peak_nms']} times, {k5_tiles} "
                             "by the tile pass")
    if not np.array_equal(labels, default_labels):
        raise AssertionError(f"nms_impl='pallas' labels != default path on "
                             f"{int((labels != default_labels).sum())} voxels")
    print("[12] nms_impl=pallas labels == default (K1) path's, elementwise")

    flood_cfg = cfg.override(**{"postproc.nms_impl": "pallas",
                                "postproc.method": "flood"})
    got = make_infer_stages(model, flood_cfg)[2](logits["plain"])
    want = make_infer_stages(model, flood_cfg, plain=True)[2](logits["plain"])
    if not torch.equal(got, want):
        raise AssertionError(f"method='flood': kernels != twins on "
                             f"{int((got != want).sum())} voxels")
    print(f"[12] method=flood, nms_impl=pallas: kernels == twins elementwise "
          f"({int(got.max())} instances)")

    # warm post-processing time of each composition on the same logits
    post_ms = {}
    for tag, c in (("default", cfg),
                   ("nms_impl=pallas",
                    cfg.override(**{"postproc.nms_impl": "pallas"})),
                   ("method=flood, nms_impl=pallas", flood_cfg)):
        post = make_infer_stages(model, c)[2]
        post(logits["plain"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post(logits["plain"])
        torch.cuda.synchronize()
        post_ms[tag] = round(1e3 * (time.perf_counter() - t0), 1)
    print(f"[12] warm post-processing ms by composition: {post_ms}")
    check_launches_per_pass(torch.sigmoid(logits["plain"]["fg_logits"]).float(),
                            torch.sigmoid(logits["plain"]["peak_logits"]).float())
    return ({"fused_convblock": k4_launches,
             "fused_peak_nms": launches["fused_peak_nms"]},
            {"fused_peak_nms": k5_tiles})


def no_host_reads(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    PyTorch call in it that waits for the device (a copy to the host, an
    ``.item()``, a ``torch.unique`` or ``torch.bincount`` on the card)
    raises. The mode is set back in any case."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _probabilities(model, cfg, vol):
    """The sweep's fg and peak probabilities of ``vol`` under ``cfg``,
    float32, as the post-processing stage computes them."""
    from tpuseg_torch.infer import make_infer_stages

    logits = make_infer_stages(model, cfg)[1](vol)
    return tuple(torch.sigmoid(logits[k]).float()
                 for k in ("fg_logits", "peak_logits"))


def phase_hist_kernels(vol, fg, labels) -> dict:
    """(a) H1 under both bin rules against its twin, elementwise, on the
    main stack (normalization: the image; calibration: the seeded-weights
    fg probabilities) and on a stack of 2**25 voxels (the main stack and
    its first 32 planes again); H2 bit-equal to its twin (numpy's float32
    cumsum) on each of those counts; H3 against ``torch.bincount`` on the
    seeded-weights watershed's index labels. Then each kernel's time at
    the main path's shapes beside its twin's, the library call's and its
    bound; returns the records.

    Bounds: H1 must read its sample (4 B a voxel) for ~5 float32
    operations a voxel (the bin index) and write 4096 int64 counts; H2
    must read the counts (32 KB) for two operations a bin (its time is a
    chain of 4096 dependent float32 adds, which no rate bounds); H3 must
    read the labels and write the (N+1,) int32 table (8 B a voxel) for one
    operation a voxel. Library calls: ``torch.histc`` for H1 (its bin edges
    round otherwise: timing only), none for H2, ``torch.bincount`` for H3
    (int64 counts)."""
    from tpuseg_torch.ops import hist

    stride = 4                          # data.normalize_sample_stride
    big = torch.cat([vol, vol[:32]])
    big_fg = torch.cat([fg, fg[:32]])
    if big.numel() < 2 ** 25:
        raise AssertionError(f"the large stack has {big.numel()} voxels")
    out = {}

    def rows(x):
        flat = x.reshape(1, -1)
        lo = flat.min(dim=1).values
        return flat, lo, torch.clamp(flat.max(dim=1).values - lo, min=1e-12)

    checked = []
    for tag, x, rule in (("main stack, normalize", vol, "normalize"),
                         ("main stack sampled 1:4, normalize",
                          vol[..., ::stride].contiguous(), "normalize"),
                         ("seeded-weights fg, calibrate", fg, "calibrate"),
                         ("2^25 stack, normalize", big, "normalize"),
                         ("2^25 stack fg, calibrate", big_fg, "calibrate")):
        flat, lo, span = rows(x)
        if rule == "calibrate":
            lo, span = torch.zeros_like(lo), torch.ones_like(span)
        got = hist.bin_counts(flat, lo, span, rule=rule)
        want = hist.bin_counts_plain(flat, lo, span, rule=rule)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0 or int(got.sum()) != flat.numel():
            raise AssertionError(f"[18] H1 on {tag}: kernel != twin (max abs "
                                 f"err {err})")
        pcts = (1.0, 99.8, 50.0, 99.995)
        p_got = hist.percentiles(got, flat.numel(), lo, span, pcts)
        p_want = hist.percentiles_plain(got.cpu(), flat.numel(), lo.cpu(),
                                        span.cpu(), pcts)
        if not torch.equal(p_got.cpu(), p_want):
            raise AssertionError(f"[18] H2 on {tag}: {p_got.tolist()} != twin "
                                 f"{p_want.tolist()}")
        checked.append(f"{tag} ({flat.numel()} samples, largest bin "
                       f"{int(got.max())})")
    print("[18] (a) H1 == twin elementwise and H2 == twin bitwise on: "
          + "; ".join(checked))

    counts = hist.label_counts(labels)
    want = torch.bincount(labels.reshape(-1).long(),
                          minlength=labels.numel() + 1).to(torch.int32)
    want[0] = 0
    if not torch.equal(counts, want):
        raise AssertionError(f"[18] H3 != torch.bincount on "
                             f"{int((counts != want).sum())} labels")
    print(f"[18] (a) H3 == torch.bincount on the seeded-weights index labels "
          f"({int((counts > 0).sum())} labels, largest "
          f"{int(counts.max())} voxels)")

    # times at the main path's shapes: H1 on the 1:4 sample, H2 on its
    # counts, H3 on the index labels; H1's calibration rule beside
    flat, lo, span = rows(vol[..., ::stride].contiguous())
    n = flat.numel()
    lo_f, hi_f = float(lo), float(lo + span)
    h1 = hist.bin_counts(flat, lo, span)
    fg_flat = fg.reshape(1, -1)
    out["bin_counts"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: hist.bin_counts(flat, lo, span), 20),
        plain_ms=cuda_ms(lambda: hist.bin_counts_plain(flat, lo, span), 5),
        library_ms=cuda_ms(lambda: torch.histc(flat, 4096, lo_f, hi_f), 20),
        calibrate_ms=cuda_ms(lambda: hist.bin_counts(fg_flat,
                                                     rule="calibrate"), 20),
        calibrate_plain_ms=cuda_ms(lambda: hist.bin_counts_plain(
            fg_flat, None, None, rule="calibrate"), 5),
        **bound(4 * n + 8 * 4096, 5 * n, F32_FLOPS))
    pcts = (1.0, 99.8)
    out["percentiles"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: hist.percentiles(h1, n, lo, span, pcts), 20),
        plain_ms=cuda_ms(lambda: hist.percentiles_plain(h1, n, lo, span, pcts),
                         5),
        library_ms=None, **bound(8 * 4096 + 8 * 2, 2 * 4096, F32_FLOPS))
    nl = labels.numel()
    flat_labels = labels.reshape(-1)
    out["label_counts"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: hist.label_counts(labels), 20),
        plain_ms=cuda_ms(lambda: hist.label_counts_plain(labels), 5),
        library_ms=cuda_ms(lambda: torch.bincount(flat_labels,
                                                  minlength=nl + 1), 5),
        **bound(8 * nl + 4, nl, F32_FLOPS))
    for name, r in out.items():
        print(f"[18] {name}: kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.3f}"
              f" ms, library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                 else "none")
              + f", bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
              + (f"; calibration rule on the fg map {r['calibrate_ms']:.4f} "
                 f"ms, twin {r['calibrate_plain_ms']:.3f} ms"
                 if "calibrate_ms" in r else ""))
    del big, big_fg
    return out


def phase_device_thresholds(maps) -> None:
    """(b) K1 and K5 with their thresholds as 0-d device tensors == the same
    thresholds as host floats == the twins, on each ``(name, fg, pk,
    peak_threshold, fg_threshold, radius)`` of ``maps`` (a tensor threshold
    is the calibrated one, as the pipeline passes it)."""
    from tpuseg_torch.ops.nms import fused_peak_nms, fused_peak_nms_plain
    from tpuseg_torch.ops.seed import seed_chase_pass, seed_chase_pass_plain

    def dev(v):
        return v if isinstance(v, torch.Tensor) else torch.full(
            (), v, dtype=torch.float32, device="cuda")

    for name, fg, pk, p_thr, f_thr, radius in maps:
        host = (float(p_thr), float(f_thr))
        a = seed_chase_pass(pk, fg, *host, radius)
        b = seed_chase_pass(pk, fg, dev(p_thr), dev(f_thr), radius)
        c = seed_chase_pass_plain(pk, fg, *host, radius)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(a, b, c)):
            raise AssertionError(f"[18] K1 on {name}: device thresholds != "
                                 "host floats != twin")
        s_host = fused_peak_nms(pk, host[0], radius)
        s_dev = fused_peak_nms(pk, dev(p_thr), radius)
        if not (torch.equal(s_host, s_dev)
                and torch.equal(s_dev, fused_peak_nms_plain(pk, host[0],
                                                            radius))):
            raise AssertionError(f"[18] K5 on {name}: device threshold != "
                                 "host float != twin")
        print(f"[18] (b) {name}: K1 and K5 with device thresholds (peak "
              f"{host[0]:.6g}, fg {host[1]:.6g}, radius {tuple(radius)}) == "
              f"host floats == twins ({int(s_dev.sum())} seeds)")


def _resolve_inputs(fg, pk, p_thr, f_thr, radius):
    """What the watershed gives K2 and K3: K1's (dirs, v), the mask, and the
    chase's result."""
    from tpuseg_torch.ops.resolve import chase_resolve_plain
    from tpuseg_torch.ops.seed import seed_chase_pass

    fgm = fg >= f_thr
    dirs, v = seed_chase_pass(pk, fg, p_thr, f_thr, radius)
    return fgm, dirs, v, chase_resolve_plain(v, dirs, fgm).clamp(min=0)


def check_gated_loops(name, fg, fgm, dirs, v, v_res) -> tuple:
    """(c) The gated ``chase_resolve`` and ``flood_resolve`` == the twins'
    host-read loops, with as many passes run and the same gates (the card's
    slots against the counts and flags the loops read). Returns (chase,
    flood) passes run."""
    from tpuseg_torch.ops.resolve import (chase_resolve, chase_resolve_plain,
                                          flood_resolve, flood_resolve_plain,
                                          passes_run)

    runs = []
    for what, kern, plain in (
            ("chase", chase_resolve, chase_resolve_plain),
            ("flood", flood_resolve, flood_resolve_plain)):
        args = ((v, dirs, fgm) if what == "chase"
                else (v_res, fgm, fg, 96))
        got, want = kern(*args), plain(*args)
        ran, ran_plain = (passes_run(kern.last_gates),
                          passes_run(plain.last_gates))
        gates = kern.last_gates[:plain.last_gates.numel()].cpu()
        if (not torch.equal(got, want) or ran != ran_plain
                or not torch.equal(gates, plain.last_gates)):
            raise AssertionError(
                f"[18] gated {what} on {name}: {int((got != want).sum())} "
                f"voxels differ; passes run {ran}, the twin's loop "
                f"{ran_plain}; gates {gates.tolist()[:8]}..., the twin's "
                f"{plain.last_gates.tolist()[:8]}...")
        runs.append(ran)
    print(f"[18] (c) {name}: gated chase == twin loop in {runs[0]} passes "
          f"run of 128 enqueued, gated flood == twin loop in {runs[1]} "
          "passes run of 12 enqueued")
    return tuple(runs)


def time_gated_loops(fgm, dirs, v, v_res, fg, chase_runs: int) -> dict:
    """(e) The seeded-weights resolves, gated on the device, against the
    same pass kernels driven by a host-read loop written here (one read of
    the count or the flag after each pass), and the chase's idle pass:
    128 passes on an input already resolved (every pass idle, two copy)
    against 2. CUDA events, which count the device's idle time too."""
    from tpuseg_torch.ops.resolve import (chase_pass, chase_resolve,
                                          flood_pass, flood_resolve)

    def chase_host_loop():
        x = v
        n = int((fgm & (x == 0)).sum())
        i = 0
        while n > 0 and i < 128:
            x, c = chase_pass(x, dirs, fgm, 8)
            n = int(c)
            i += 1
        return x

    pot = torch.where(fgm, fg.float(), float("-inf"))
    lab0 = torch.where(fgm, v_res, 0).to(torch.int32)

    def flood_host_loop():
        x, changed, i = lab0, True, 0
        while changed and i < 12:
            x, ch = flood_pass(pot, x, 8)
            changed = bool(ch)
            i += 1
        return x

    if not (torch.equal(chase_host_loop(), chase_resolve(v, dirs, fgm))
            and torch.equal(flood_host_loop(),
                            flood_resolve(v_res, fgm, fg, 96))):
        raise AssertionError("[18] host-read loops != gated loops")
    done = chase_resolve(v, dirs, fgm)
    t = {}
    for turn in range(2):
        for tag, fn in (
                ("chase gated", lambda: chase_resolve(v, dirs, fgm)),
                ("chase host loop", chase_host_loop),
                ("chase gated, no idle pass",
                 lambda: chase_resolve(v, dirs, fgm, max_passes=chase_runs)),
                ("flood gated", lambda: flood_resolve(v_res, fgm, fg, 96)),
                ("flood host loop", flood_host_loop),
                ("chase 128 idle", lambda: chase_resolve(done, dirs, fgm)),
                ("chase 2 idle", lambda: chase_resolve(done, dirs, fgm,
                                                       max_passes=2))):
            t.setdefault(tag, []).append(cuda_ms(fn, 5))
    best = {k: min(x) for k, x in t.items()}
    idle_us = 1e3 * (best["chase 128 idle"] - best["chase 2 idle"]) / 126
    extra = best["chase gated"] - best["chase gated, no idle pass"]
    print("[18] (e) seeded-weights resolves, ms (two turns): "
          + "; ".join(f"{k} {' / '.join(f'{x:.3f}' for x in v_)}"
                      for k, v_ in t.items()))
    print(f"[18] (e) chase: one idle pass {idle_us:.2f} us; the "
          f"{128 - chase_runs} idle passes of the gated resolve cost "
          f"{extra:.3f} ms over {chase_runs} passes run alone; the host-read "
          f"loop {best['chase host loop'] - best['chase gated']:+.3f} ms "
          f"against the gated resolve")
    return {"idle_pass_us": idle_us, "idle_passes_ms": extra, **best}


def phase_one_program(sv, ckpt_dir: str, ann_path: str, fixtures, tmp: str):
    """Phase 18: one-volume inference as one device program. Returns the
    records of H1-H3 (``phase_hist_kernels``) and the times of (e)."""
    import dataclasses

    from tpuseg_torch.ckpt import load_pth
    from tpuseg_torch.cli.infer import calibrated
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import synthesize_touching_volume
    from tpuseg_torch.infer import (make_batched_infer_fn, make_infer_fn,
                                    make_infer_stages)
    from tpuseg_torch.models import build_model
    from tpuseg_torch.ops import watershed
    from tpuseg_torch.ops.calibrate import threshold_for_fraction
    from tpuseg_torch.ops.resolve import chase_resolve, passes_run
    from tpuseg_torch.utils import hard_sync

    cfg = Config()
    ckpt = os.path.join(tmp, "seeded18.pth")
    write_seeded_checkpoint(ckpt, cfg.model)
    seeded = build_model(cfg.model)
    seeded.load_state_dict(load_pth(ckpt))
    seeded.cuda()
    vol = torch.from_numpy(sv.image).cuda()
    fg, pk = _probabilities(seeded, cfg, vol)
    pp = cfg.postproc
    labels = watershed(fg, pk, peak_threshold=pp.peak_threshold,
                       fg_threshold=pp.fg_threshold, peak_radius=pp.nms_radius)
    records = phase_hist_kernels(vol, fg, labels)
    del labels

    if fixtures is None:
        fixtures = {name: synthesize_touching_volume(**C5_KW, **kw)
                    for name, kw in C5_FIXTURES.items()}
    c3, cfgs = c5_configs(fixtures)
    model = trained_model(ckpt_dir, c3)
    vols = torch.stack([torch.from_numpy(tv.image)
                        for tv in fixtures.values()]).cuda()
    probs = {}
    for i, (name, c) in enumerate(cfgs.items()):
        f, p = _probabilities(model, c, vols[i])
        thr = threshold_for_fraction(
            f, c.postproc.fg_target_fraction,
            sample_stride=c.data.normalize_sample_stride)
        probs[name] = (f, p, c.postproc.peak_threshold, thr,
                       tuple(c.postproc.nms_radius))
    r3 = (2, 2, 2)
    phase_device_thresholds([
        ("the seeded-weights maps", fg, pk, pp.peak_threshold,
         pp.fg_threshold, r3),
        ("touch60_snr20's calibrated maps", *probs["touch60_snr20"][:2],
         *probs["touch60_snr20"][2:])])

    seeded_in = _resolve_inputs(fg, pk, pp.peak_threshold, pp.fg_threshold,
                                r3)
    chase_runs, _ = check_gated_loops("the seeded-weights maps", fg,
                                      *seeded_in)
    fixture_passes = {}
    for name, (f, p, p_thr, thr, radius) in probs.items():
        fgm, dirs, v, _ = _resolve_inputs(f, p, p_thr, thr, radius)
        chase_resolve(v, dirs, fgm)
        fixture_passes[name] = passes_run(chase_resolve.last_gates)
        del fgm, dirs, v
    print(f"[18] (c) chase passes run on the c5 fixtures under calibrated c3:"
          f" {fixture_passes}")
    capped = [n for n, k in fixture_passes.items() if k == 128]
    if capped:
        f, p, p_thr, thr, radius = probs[capped[0]]
        check_gated_loops(f"{capped[0]} (the 128-pass cap)", f,
                          *_resolve_inputs(f, p, p_thr, thr, radius))
    else:
        # no fixture reaches the cap: a constant peak map over the whole
        # stack, where every chain climbs +z, then +y, then +x to the one
        # root at the last voxel (95 + 511 + 511 hops, past 128 x 8)
        flat = torch.full(MAIN_SHAPE, 0.7, device="cuda")
        got = check_gated_loops("a constant peak map (the 128-pass cap)",
                                flat, *_resolve_inputs(flat, flat, 0.5, 0.5,
                                                       r3))
        if got[0] != 128:
            raise AssertionError(f"[18] the constant map ran {got[0]} chase "
                                 "passes, not the cap of 128")
        del flat
    del probs

    # (d) no host read from the call to the label tensor; the labels ==
    # the twins' post-processing of the same sweep, run outside the mode
    main_cfgs = {
        "plain apply": cfg.override(**{"infer.apply_impl": "flax"}),
        "fused apply": cfg.override(**{"infer.apply_impl": "fused"}),
        "calibrated c3": calibrated(c3, ann_path, vol.numel()),
    }
    walls = {}
    for tag, c in main_cfgs.items():
        net = seeded if tag != "calibrated c3" else model
        infer = make_infer_fn(net, c)
        hard_sync(infer(vol))                   # warm
        with PassTally() as tally:
            t0 = time.perf_counter()
            got = no_host_reads(lambda: infer(vol))
            t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls[tag] = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0))
        ran = tally.passes()
        _, stage_net, _ = make_infer_stages(net, c)
        want = make_infer_stages(net, c, plain=True)[2](stage_net(vol))
        if not torch.equal(got, want):
            raise AssertionError(f"[18] (d) {tag}: labels != the twins' on "
                                 f"{int((got != want).sum())} voxels")
        print(f"[18] (d) make_infer_fn, {tag}: no host read (sync debug mode"
              f" 'error'), {int(got.max())} instances, labels == the twins' "
              f"post-processing of the same sweep; chase / flood passes run "
              f"{ran[0]} / {ran[1]}; host enqueue {walls[tag][0]:.1f} ms, "
              f"wall {walls[tag][1]:.1f} ms")
    bcfg = cfgs["touch60_snr20"]
    batched, single = (make_batched_infer_fn(model, bcfg),
                       make_infer_fn(model, bcfg))
    hard_sync(batched(vols))
    with PassTally() as tally:
        got = no_host_reads(lambda: batched(vols))
    ran = tally.passes()
    _, stage_net, _ = make_infer_stages(model, bcfg)
    post_plain = make_infer_stages(model, bcfg, plain=True)[2]
    for i in range(len(vols)):
        want = post_plain(stage_net(vols[i]))
        if not torch.equal(got[i], want):
            raise AssertionError(f"[18] (d) batched volume {i}: labels != the"
                                 f" twins' on {int((got[i] != want).sum())} "
                                 "voxels")
    print(f"[18] (d) make_batched_infer_fn on the five c5 fixtures "
          f"({len(vols)}, {', '.join(map(str, MAIN_SHAPE))}): no host read, "
          "labels == the twins' post-processing per volume; chase / flood "
          f"passes run {ran[0]} / {ran[1]} in all")

    # (e) warm times, in turns
    runs = {"batched": [], "five single calls": []}
    for tag in ("batched", "five single calls", "five single calls",
                "batched"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tag == "batched":
            batched(vols)
        else:
            for i in range(len(vols)):
                single(vols[i])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        runs[tag].append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)))
    print("[18] (e) " + "; ".join(
        f"{tag}: host enqueue / wall "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in r) + " ms"
        for tag, r in runs.items()))
    timing = time_gated_loops(*seeded_in[:4], fg, chase_runs)
    del vols, model, seeded
    torch.cuda.empty_cache()
    return records, {"resolve_ms": timing, "main_path_ms": walls,
                     "batched_ms": runs, "chase_passes_seeded": chase_runs,
                     "chase_passes_c5": fixture_passes}


def u1_inputs(seeded, cfg, vol):
    """Phase 19 (a)'s inputs of U1, by name: the saddle-merge edges of the
    seeded-weights stack (merge 0.8, the main path's load), random graphs
    of 10^3-10^6 edges over half as many values (a tenth of the rows hold
    a 0), a 2^20-long path in bit-reversed order with its edges shuffled,
    a star of 2^20 leaves and a table of sentinels only."""
    from tpuseg_torch.ops import watershed
    from tpuseg_torch.ops.merge import saddle_merge_edges

    pp = cfg.postproc
    fg, pk = _probabilities(seeded, cfg, vol)
    labels = watershed(fg, pk, peak_threshold=pp.peak_threshold,
                       fg_threshold=pp.fg_threshold, peak_radius=pp.nms_radius)
    u, v, dropped = saddle_merge_edges(labels, pk, U1_MERGE_RATIO,
                                       pp.merge_max_pairs)
    print(f"[19] (a) the stack's merge edges: {int((u != SENT32).sum())} "
          f"passing of {u.numel()} slots, dropped {dropped.tolist()}")
    out = {"merge edges, seeded weights": (u, v)}
    del fg, pk, labels
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for e in U1_RANDOM_EDGES:
        u, v = (torch.randint(1, e // 2 + 1, (e,), device="cuda",
                              generator=gen, dtype=torch.int32)
                for _ in range(2))
        u[::10] = 0
        out[f"random graph, {e} edges"] = (u, v)
    bits = U1_PATH_BITS
    idx = torch.arange(1 << bits, device="cuda")
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    order = (rev + 1).to(torch.int32)
    perm = torch.randperm((1 << bits) - 1, device="cuda", generator=gen)
    out[f"path of 2^{bits} in bit-reversed order"] = (
        order[:-1][perm].contiguous(), order[1:][perm].contiguous())
    leaves = torch.arange(2, (1 << bits) + 2, device="cuda",
                          dtype=torch.int32)
    out[f"star of 2^{bits} leaves"] = (torch.ones_like(leaves), leaves)
    sent = torch.full((1 << bits,), SENT32, device="cuda", dtype=torch.int32)
    out["sentinels only"] = (sent, sent.clone())
    return out


def phase_union_closure(inputs) -> dict:
    """(a) U1 against its twin, elementwise (keys and reps), on every input
    of ``u1_inputs``; the time of each beside the twin's and the bound
    (reading u and v once, writing keys and reps once). Returns the
    kernels' record of U1 at the merge edges, the main path's shape."""
    from tpuseg_torch.ops.closure import union_closure, union_closure_plain

    rec = None
    for name, (u, v) in inputs.items():
        keys, reps = union_closure(u, v)
        pk, pr = union_closure_plain(u, v)
        if not (torch.equal(keys, pk) and torch.equal(reps, pr)):
            raise AssertionError(f"[19] (a) U1 != its twin on {name}: "
                                 f"{int((reps != pr).sum())} slots differ")
        k = u.element_size()
        b = bound(2 * u.numel() * k + 2 * keys.numel() * k,
                  2 * keys.numel(), F32_FLOPS)
        ms = cuda_ms(lambda: union_closure(u, v), 10)
        plain = cuda_ms(lambda: union_closure_plain(u, v), 2)
        groups = int(torch.unique(reps[keys != SENT32]).numel())
        print(f"[19] (a) U1 on {name}: == twin ({u.numel()} edges, "
              f"{groups} groups); {ms:.4f} ms, twin {plain:.3f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
        if rec is None:
            rec = {"max_abs_err": max_abs_err(reps, pr), "ms": ms,
                   "plain_ms": plain, "library_ms": None, **b}
    return rec


class MergeInputs:
    """Within: every ``saddle_merge`` call of the one-volume post stage
    (``infer.pipeline``) keeps its labels and peak map on ``.seen``: the
    merge's inputs on the main path."""

    def __enter__(self):
        from tpuseg_torch.infer import pipeline

        self.seen, self._merge = [], pipeline.saddle_merge

        def kept(labels, peak_prob, *args, **kw):
            self.seen.append((labels, peak_prob))
            return self._merge(labels, peak_prob, *args, **kw)

        pipeline.saddle_merge = kept
        return self

    def __exit__(self, *exc):
        from tpuseg_torch.infer import pipeline

        pipeline.saddle_merge = self._merge


def phase_one_program_merge(seeded, model, vol, cfg, c3, acc: dict):
    """(b) ``make_infer_fn`` with merge 0.8 and diagnostics, inside
    ``set_sync_debug_mode("error")`` after one warm call, on the stack
    (fused apply, seeded weights) and calibrated c3 (phase 9's): labels,
    the truncation count and the merge's dropped counts equal the
    ``plain=True`` post-processing of the same sweep, run outside the
    mode; U1, M1 and M2 launched once a call. Their launches into ``acc``.
    Returns the calls' host enqueue and wall ms, and the merge's inputs
    (labels, peak map) of each load, kept from the warm call."""
    from tpuseg_torch.infer import make_infer_fn, make_infer_stages
    from tpuseg_torch.ops.merge import saddle_merge
    from tpuseg_torch.utils import hard_sync

    merge = {"postproc.merge_saddle_ratio": U1_MERGE_RATIO}
    walls, loads = {}, {}
    for tag, net, c in (("fused apply, seeded weights", seeded,
                         cfg.override(**{"infer.apply_impl": "fused"},
                                      **merge)),
                        ("calibrated c3", model, c3.override(**merge))):
        infer = make_infer_fn(net, c, with_diagnostics=True)
        with MergeInputs() as seen:
            hard_sync(infer(vol)[0])                # warm
        loads[tag] = seen.seen[0]
        _reset_launches()
        t0 = time.perf_counter()
        got, diag = no_host_reads(lambda: infer(vol))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls[tag] = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0))
        _add_launches(acc)
        n_u1 = _launches()["union_closure"]
        n_pair = [_launches()[k] for k in PAIR_KERNELS]
        dropped = saddle_merge.last_dropped
        if diag["flood_truncated"].device.type != "cuda" or \
                dropped.device.type != "cuda":
            raise AssertionError("[19] (b) the counts left the card")
        _, stage_net, _ = make_infer_stages(net, c)
        want, wdiag = make_infer_stages(net, c, with_diagnostics=True,
                                        plain=True)[2](stage_net(vol))
        same = (torch.equal(got, want)
                and int(diag["flood_truncated"])
                == int(wdiag["flood_truncated"])
                and dropped.tolist() == saddle_merge.last_dropped.tolist())
        line = (f"[19] (b) make_infer_fn, {tag}, merge {U1_MERGE_RATIO}, "
                f"with diagnostics: no host read, {int(got.max())} "
                f"instances, truncated {int(diag['flood_truncated'])}, "
                f"dropped {dropped.tolist()}; U1 launches {n_u1}, M1/M2 "
                f"{n_pair}; host enqueue {walls[tag][0]:.1f} ms, wall "
                f"{walls[tag][1]:.1f} ms")
        if not same or n_u1 != 1 or n_pair != [1, 1]:
            raise AssertionError(line + f"; labels or counts != the twins' "
                                 f"({int((got != want).sum())} voxels)")
        print(line + "; labels and counts == the twins'", flush=True)
    return walls, loads


def _sharded_no_read(infer, shards, mesh):
    """``infer(shards)`` inside the sync debug mode, then the labels
    gathered to the host (``unshard``, the one read) and the call's
    counts printed after them (``report_sharded_counts``): ``(labels,
    printed)``."""
    import contextlib
    import io

    from tpuseg_torch.infer import unshard
    from tpuseg_torch.infer.sharded import report_sharded_counts

    out = no_host_reads(lambda: infer(shards))
    labels = unshard(out, mesh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report_sharded_counts(infer)
    return labels, buf.getvalue()


def phase_sharded_no_read(sv, model, c3, acc: dict) -> None:
    """(c) ``make_sharded_infer_fn``'s ``infer(shards)`` inside the sync
    debug mode, every shard on ``cuda:0``, meshes z2,y2 and z2, calibrated
    or not, merge 0 or 0.8, after one warm call a net and mesh: AnalyticNet
    in float32 on the pre-normalized stack equal to the one-shot
    ``make_infer_fn`` (as [15a] holds them) and to ``plain=True``; phase
    9's net under calibrated c3 (uncalibrated: ``fg_target_fraction`` 0)
    equal to ``plain=True`` (with the module apply: the fused apply's twin
    rounds bf16 otherwise, phase 12); then a z2 call
    with ``shard_max_labels=8``, whose overflow prints after the labels in
    the reference's words. ``plain=True`` runs every twin, M1 and M2's
    too (the merge's on each shard's grown core, a view of its slab); the
    call launches U1 once and once more with the merge, and M1 and M2 once
    a shard with the merge. The launches into ``acc``."""
    import dataclasses

    from tpuseg_torch.core import Config, InferConfig
    from tpuseg_torch.data.normalize import histogram_percentile_normalize
    from tpuseg_torch.infer import (make_infer_fn, make_sharded_infer_fn,
                                    shard_volume)
    from tpuseg_torch.ops.calibrate import expected_fg_fraction
    from tpuseg_torch.parallel.reconcile import SHARD_OVERFLOW
    from tpuseg_torch.utils import hard_sync

    analytic = AnalyticNet().cuda()
    base = Config(infer=InferConfig(compute_dtype="float32"))
    v = histogram_percentile_normalize(
        torch.from_numpy(sv.image)[None].cuda())[0].cpu().numpy()
    frac = expected_fg_fraction(sv.half_sizes, sv.image.size)
    trained = c3.override(**{"infer.apply_impl": "flax"})
    legs = (("AnalyticNet", analytic, v, False, base,
             {"fg_target_fraction": frac}),
            ("c3", model, sv.image, True, trained,
             {"fg_target_fraction": trained.postproc.fg_target_fraction}))
    for net_tag, net, vol, norm, cfg0, cal in legs:
        for name, shape in (("z2,y2", (2, 2)), ("z2", (2,))):
            mesh = _card_mesh(shape)
            shards = shard_volume(vol, mesh)
            for k, (ratio, fraction) in enumerate(
                    [(U1_MERGE_RATIO, cal["fg_target_fraction"]),
                     (0.0, 0.0), (0.0, cal["fg_target_fraction"]),
                     (U1_MERGE_RATIO, 0.0)]):
                cfg = dataclasses.replace(cfg0, postproc=dataclasses.replace(
                    cfg0.postproc, merge_saddle_ratio=ratio,
                    fg_target_fraction=fraction))
                infer = make_sharded_infer_fn(net, cfg, mesh, normalize=norm)
                if k == 0:
                    hard_sync(infer(shards))        # warm: a net and mesh
                _reset_launches()
                got, printed = _sharded_no_read(infer, shards, mesh)
                _add_launches(acc)
                n_u1 = _launches()["union_closure"]
                n_pair = [_launches()[k] for k in PAIR_KERNELS]
                twin, _, _ = _sharded(net, cfg, mesh, vol, normalize=norm,
                                      plain=True)
                tag = (f"{net_tag}, mesh {name}, "
                       f"{'calibrated' if fraction else 'uncalibrated'}, "
                       f"merge {ratio}")
                bad = [] if np.array_equal(got, twin) else ["plain=True"]
                if net_tag == "AnalyticNet":
                    want = make_infer_fn(net, cfg, normalize=False)(
                        torch.from_numpy(vol).cuda()).cpu().numpy()
                    if not np.array_equal(got, want):
                        bad.append("one-shot")
                shards_merged = int(np.prod(shape)) * (ratio > 0)
                if bad or n_u1 != 1 + (ratio > 0) or printed \
                        or n_pair != [shards_merged] * 2:
                    raise AssertionError(
                        f"[19] (c) {tag}: labels != {bad}; U1 launches "
                        f"{n_u1}, M1/M2 {n_pair}; printed {printed!r}")
                print(f"[19] (c) {tag}: no host read, {int(got.max())} "
                      f"instances == plain=True"
                      + (" == one-shot" if net_tag == "AnalyticNet" else "")
                      + f"; U1 launches {n_u1}, M1/M2 {n_pair}", flush=True)
            del shards
    mesh = _card_mesh((2,))
    cfg = base.override(**{"infer.shard_max_labels": 8})
    infer = make_sharded_infer_fn(analytic, cfg, mesh, normalize=False)
    shards = shard_volume(v, mesh)
    hard_sync(infer(shards))
    got, printed = _sharded_no_read(infer, shards, mesh)
    c = int(infer.last_overflow)
    want = SHARD_OVERFLOW.format(c=c, cap=8)
    if c <= 8 or printed.strip() != want:
        raise AssertionError(f"[19] (c) shard_max_labels=8: printed "
                             f"{printed!r}, count {c}")
    print(f"[19] (c) z2, shard_max_labels=8: no host read, "
          f"{int(got.max())} instances kept; printed after the labels: "
          f"{printed.strip()}")


def merge_split(labels, pk, max_pairs: int) -> dict:
    """The merge at 0.8 on its main-path inputs in its three parts, ms
    (CUDA events): the edges (M1 + M2), the closure (U1; of it, the key
    table's sort and ``searchsorted`` front end), the apply
    (``searchsorted``); the edges through the twin's sorts; and the peak
    device memory above the inputs (MiB) of the whole merge through M1/M2
    and through the twin's sorts with U1 (the merge before M1/M2)."""
    from tpuseg_torch.ops.closure import _table, union_closure
    from tpuseg_torch.ops.merge import apply_merge_table, saddle_merge_edges

    r = U1_MERGE_RATIO

    def edges(plain=False):
        return saddle_merge_edges(labels, pk, r, max_pairs, plain=plain)

    u, v, _ = edges()
    keys, roots = union_closure(u, v)
    out = {"edges_ms": cuda_ms(edges, 10),
           "closure_ms": cuda_ms(lambda: union_closure(u, v), 10),
           "closure_front_ms": cuda_ms(lambda: _table(u, v), 10),
           "apply_ms": cuda_ms(lambda: apply_merge_table(labels, keys, roots),
                               10),
           "sort_edges_ms": cuda_ms(lambda: edges(True), 3)}
    del u, v, keys, roots
    for tag, plain in (("kernels", False), ("sorts", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        e = edges(plain)
        merged = apply_merge_table(labels, *union_closure(*e[:2]))
        torch.cuda.synchronize()
        out[f"peak_mib_{tag}"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 20
        del e, merged
    return out


def phase_merge_times(seeded, model, vol, cfg, c3, loads) -> dict:
    """(d) warm times, in turns: the post stage with the merge off and at
    0.8 on the same logits (the seeded weights' fused sweep, and c3's),
    with each run's peak device memory above its inputs; the merge on (b)'s
    inputs of each in its parts (``merge_split``); and calibrated c3
    (phase 9's net, fused) through ``make_infer_fn`` beside
    ``make_sharded_infer_fn`` on z2,y2: host enqueue and wall ms."""
    from tpuseg_torch.infer import (make_infer_fn, make_infer_stages,
                                    make_sharded_infer_fn, shard_volume)
    from tpuseg_torch.utils import hard_sync

    post, split = {}, {}
    for tag, net, c in (("seeded weights", seeded,
                         cfg.override(**{"infer.apply_impl": "fused"})),
                        ("calibrated c3", model, c3)):
        logits = make_infer_stages(net, c)[1](vol)
        stages = {r: make_infer_stages(net, c.override(
            **{"postproc.merge_saddle_ratio": r}))[2]
            for r in (0.0, U1_MERGE_RATIO)}
        runs = {r: [] for r in stages}
        peaks = {r: [] for r in stages}
        for r in (0.0, U1_MERGE_RATIO, U1_MERGE_RATIO, 0.0):
            hard_sync(stages[r](logits))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            stages[r](logits)
            torch.cuda.synchronize()
            runs[r].append(1e3 * (time.perf_counter() - t0))
            peaks[r].append((torch.cuda.max_memory_allocated() - base)
                            / 2 ** 20)
        post[tag] = runs
        print(f"[19] (d) post ms, {tag}: merge off "
              f"{', '.join(f'{t:.2f}' for t in runs[0.0])}; merge "
              f"{U1_MERGE_RATIO} "
              f"{', '.join(f'{t:.2f}' for t in runs[U1_MERGE_RATIO])}; "
              f"peak MiB above the logits: off "
              f"{', '.join(f'{m:.1f}' for m in peaks[0.0])}, on "
              f"{', '.join(f'{m:.1f}' for m in peaks[U1_MERGE_RATIO])}")
        del logits
    for tag, (labels, pk) in loads.items():
        split[tag] = merge_split(labels, pk, cfg.postproc.merge_max_pairs)
        print(f"[19] (d) the merge at {U1_MERGE_RATIO}, {tag} "
              f"({pk.dtype}): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in split[tag].items()),
              flush=True)
    one = make_infer_fn(model, c3)
    mesh = _card_mesh((2, 2))
    shard = make_sharded_infer_fn(model, c3, mesh)
    shards = shard_volume(vol.cpu().numpy(), mesh)
    hard_sync(one(vol))
    hard_sync(shard(shards))
    calls = {"one-shot": [], "--shard z2,y2": []}
    for tag in ("one-shot", "--shard z2,y2", "--shard z2,y2", "one-shot"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tag == "one-shot":
            one(vol)
        else:
            shard(shards)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        calls[tag].append((1e3 * (t1 - t0),
                           1e3 * (time.perf_counter() - t0)))
    print("[19] (d) calibrated c3, fused: " + "; ".join(
        f"{tag}: host enqueue / wall "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in r) + " ms"
        for tag, r in calls.items()))
    return {"post_ms": post, "calls_ms": calls, "merge_split": split}


def pair_table_check(tag, labels, pk, max_pairs, core=None, basin=None,
                     merged=True) -> dict:
    """(e) on one load: M1 + M2 against the twin elementwise (``lo``,
    ``hi``, ``dropped``) at merge 0.8, and with ``merged`` the merged
    labels against ``plain=True``'s; then each kernel's time (CUDA events;
    M2 alone on one M1 table) beside the twin's and each one's bound.
    ``core``/``basin``: a shard's grown core, as ``saddle_merge_core_edges``
    takes it. Returns the kernels' records and the table's counts."""
    from tpuseg_torch.ops.merge import (pair_aggregate, pair_slots,
                                        saddle_merge, saddle_merge_core_edges,
                                        saddle_merge_edges)

    r = U1_MERGE_RATIO
    core = tuple(labels.shape) if core is None else tuple(core)

    def twin():
        if basin is None:
            return saddle_merge_edges(labels, pk, r, max_pairs, plain=True)
        return saddle_merge_core_edges(labels, pk, core, r, basin, max_pairs,
                                       plain=True)

    table = pair_aggregate(labels, pk, core, max_pairs)
    got = pair_slots(table, pk if basin is None else basin, r, max_pairs)
    want = twin()
    faces, pairs = table.meta[:3].tolist(), table.meta[3:].tolist()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    routes = ["select" if p > 2 * max_pairs else "buffer" for p in pairs]
    view = "" if labels.is_contiguous() else "(a view) "
    line = (f"[19] (e) M1/M2 on {tag} {tuple(labels.shape)} {view}"
            f"{pk.dtype}, max_pairs {max_pairs}: faces {faces}, distinct "
            f"pairs {pairs}, routes {routes}, dropped {got[2].tolist()}, "
            f"passing {int((got[0] != SENT32).sum())}")
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(line + f"; != the twin (max abs err {err})")
    if merged and not torch.equal(
            saddle_merge(labels, pk, r, max_pairs),
            saddle_merge(labels, pk, r, max_pairs, plain=True)):
        raise AssertionError(line + "; merged labels != plain=True's")
    voxels = labels.numel()
    used = sum(min(p, max_pairs) for p in pairs)
    b1 = bound(voxels * (4 + pk.element_size()) + 12 * sum(pairs),
               3 * voxels, F32_FLOPS)
    b2 = bound(12 * sum(pairs) + 8 * used + 24 * max_pairs + 12, sum(pairs),
               F32_FLOPS)
    basin_ = pk if basin is None else basin
    ms1 = cuda_ms(lambda: pair_aggregate(labels, pk, core, max_pairs), 10)
    ms2 = cuda_ms(lambda: pair_slots(table, basin_, r, max_pairs), 10)
    plain = cuda_ms(twin, 2)
    also = ", merged labels == plain=True" if merged else ""
    print(line + f"; == twin{also}; M1 {ms1:.4f} ms (bound "
          f"{b1['bound_ms']:.4f}, {b1['bound_by']}),"
          f" M2 {ms2:.4f} ms (bound {b2['bound_ms']:.4f}, {b2['bound_by']}),"
          f" twin (the sorts) {plain:.3f} ms", flush=True)
    return {"pair_aggregate": {"max_abs_err": err, "ms": ms1,
                               "plain_ms": plain, "library_ms": None, **b1},
            "pair_slots": {"max_abs_err": err, "ms": ms2, "plain_ms": plain,
                           "library_ms": None, **b2},
            "pairs": pairs}


def phase_pair_table(sv, loads, cfg) -> dict:
    """(e) M1/M2 (``ops.merge.pair_aggregate`` / ``pair_slots``) against
    the twin elementwise, merged labels too, on: the analytic maps'
    watershed of the stack, (b)'s merge inputs (seeded weights, fused;
    calibrated c3), the seeded weights at ``max_pairs`` 64 (every axis
    takes the select route), a grown core cut from the seeded weights'
    labels as a z2,y2 shard's is from its slab (a view, 49x257x512 from
    (24, 128, 0), core 48x256x512; the stack's peaks as the basins'
    maxima) and a 160x1024x1024 extended chunk (the stack tiled, analytic
    maps). Returns M1's and M2's records on the seeded weights, the main
    path's load."""
    from tpuseg_torch.ops import watershed

    pp = cfg.postproc
    mp = pp.merge_max_pairs

    def analytic_labels(image):
        fg, pk = analytic_maps(image, "cuda")
        return watershed(fg, pk, peak_threshold=pp.peak_threshold,
                         fg_threshold=pp.fg_threshold,
                         peak_radius=pp.nms_radius), pk

    out = None
    lab, pk = analytic_labels(sv.image)
    pair_table_check("the analytic maps", lab, pk, mp)
    for tag, (lab, pk) in loads.items():
        recs = pair_table_check(tag, lab, pk, mp)
        if tag.endswith("seeded weights"):
            out = recs
    lab, pk = loads["fused apply, seeded weights"]
    tiny = pair_table_check("seeded weights", lab, pk, PAIR_TINY_MAX_PAIRS)
    if not all(p > 2 * PAIR_TINY_MAX_PAIRS for p in tiny["pairs"]):
        raise AssertionError("[19] (e) max_pairs 64 missed the select route")
    d, h, _ = lab.shape
    view = (slice(d // 4, d // 4 + d // 2 + 1), slice(h // 4, h // 4 + h // 2
                                                     + 1))
    pair_table_check("a grown core of z2,y2", lab[view], pk[view], mp,
                     core=(d // 2, h // 2, lab.shape[2]),
                     basin=pk.float().reshape(-1), merged=False)
    image = np.tile(sv.image, (2, 2, 2))[:PAIR_CHUNK_SHAPE[0]]
    lab, pk = analytic_labels(image)
    del image
    pair_table_check("an extended chunk (the stack tiled)", lab, pk, mp)
    del lab, pk
    torch.cuda.empty_cache()
    return out


def phase_device_merge(sv, ckpt_dir: str, ann_path: str, tmp: str):
    """Phase 19: the saddle merge, the diagnostics and the sharded path
    with no host read. Returns U1's record and its launches on the
    phase's main-path calls ((b) and (c))."""
    from tpuseg_torch.ckpt import load_pth
    from tpuseg_torch.cli.infer import calibrated
    from tpuseg_torch.core import Config
    from tpuseg_torch.models import build_model

    cfg = Config()
    ckpt = os.path.join(tmp, "seeded19.pth")
    write_seeded_checkpoint(ckpt, cfg.model)
    seeded = build_model(cfg.model)
    seeded.load_state_dict(load_pth(ckpt))
    seeded.cuda()
    vol = torch.from_numpy(sv.image).cuda()
    rec = phase_union_closure(u1_inputs(seeded, cfg, vol))
    c3 = Config().override(**C3_SETS)
    model = trained_model(ckpt_dir, c3)
    c3 = calibrated(c3, ann_path, vol.numel())
    acc = {}
    _, loads = phase_one_program_merge(seeded, model, vol, cfg, c3, acc)
    phase_sharded_no_read(sv, model, c3, acc)
    for k in ("union_closure",) + PAIR_KERNELS:
        if not acc.get(k):
            raise AssertionError(f"[19] the merge and sharded calls never "
                                 f"launched {k}")
    times = phase_merge_times(seeded, model, vol, cfg, c3, loads)
    recs = {"union_closure": rec, **phase_pair_table(sv, loads, cfg)}
    del recs["pairs"], seeded, model, vol, loads
    torch.cuda.empty_cache()
    return recs, {k: acc[k] for k in ("union_closure",) + PAIR_KERNELS}, \
        times


def _timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"    ({label}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="",
                        help="comma-separated phases to run after 1-2, "
                             "e.g. 18 (brings 9) for one-volume inference "
                             "as one device program (default: all, with "
                             "the final record)")
    parser.add_argument("--worker", nargs=2, metavar=("LEG", "DIR"),
                        help="one process of phase 16 (started by it)")
    args = parser.parse_args(argv)
    if args.worker:
        mp_worker(*args.worker)
        return
    only = {int(p) for p in args.phases.split(",") if p}
    if 12 in only:
        only.add(4)                     # phase 12 compares with phase 4's labels
    if only & {13, 14, 15, 16, 17, 18, 19}:
        only.add(9)             # phases 13-19 infer with phase 9's checkpoint

    def want(phase):
        return not only or phase in only

    name, smi = phase_device()
    phase_build()
    from tpuseg_torch.data import synthesize_volume

    sv = synthesize_volume(shape=MAIN_SHAPE, num_instances=NUM_INSTANCES,
                           seed=SEED)
    kernels, launches, tile_launches, passes_ran = {}, {}, {}, {}
    streamed, sharded, multiproc, touching = {}, {}, {}, {}
    if want(3):
        kernels.update(_timed("phase 3", phase_kernels, sv.image))
    if want(4):
        with tempfile.TemporaryDirectory() as tmp:
            (launches, tile_launches, passes_ran, ckpt, cfg,
             default_labels) = _timed("phase 4", phase_main_path, sv.image,
                                      tmp)
            seeded = _timed("phase 4 warm", phase_warm_stages, sv.image, ckpt,
                            cfg)
            for k in kernels:           # phase 3's records, where it ran
                kernels[k]["seeded_weights"] = seeded[k]
    if want(5):
        _timed("phase 5", phase_analytic, sv)
    if want(6):
        kernels["conv3x3_raw"] = _timed("phase 6", phase_conv)
    if want(7):
        with tempfile.TemporaryDirectory() as tmp:
            launches["conv3x3_raw"] = _timed(
                "phase 7", phase_train_main_path, tmp)["conv3x3_raw"]
    if want(8):
        _timed("phase 8", phase_fused_vs_plain)
    if want(9):
        with tempfile.TemporaryDirectory() as tmp:
            trained = _timed("phase 9", phase_trained_quality, sv, tmp)
            if want(13):
                _timed("phase 13", phase_bench_configs, sv, *trained, tmp)
            stream_sv = None
            if want(14):
                streamed, stream_sv = _timed("phase 14", phase_stream,
                                             trained[0], tmp)
            if want(15):
                sharded = _timed("phase 15", phase_sharded, sv, stream_sv,
                                 *trained, tmp)
            del stream_sv
            if want(16):
                multiproc = _timed("phase 16", phase_multiprocess, sv,
                                   *trained[:3], tmp)
            c5 = None
            if want(17):
                touching, c5 = _timed("phase 17", phase_touching, trained[0],
                                      tmp)
            if want(18):
                hist_recs, _ = _timed("phase 18", phase_one_program, sv,
                                      trained[0], trained[2], c5, tmp)
                kernels.update(hist_recs)
            del c5
            if want(19):
                recs, counts, _ = _timed("phase 19", phase_device_merge, sv,
                                         trained[0], trained[2], tmp)
                kernels.update(recs)
                launches.update(counts)
    if want(10):
        kernels["fused_convblock"] = _timed("phase 10", phase_convblock)
    if want(11):
        kernels["fused_peak_nms"] = _timed("phase 11", phase_nms, sv.image)
    if want(12):
        with tempfile.TemporaryDirectory() as tmp:
            more, more_tiles = _timed("phase 12", phase_fused_main_path,
                                      sv.image, default_labels, tmp)
            launches.update(more)
            tile_launches.update(more_tiles)
    if only:
        print(f"phases {sorted(only)} passed; run without --phases for the "
              "whole check and its record")
        return

    record = [{"name": k, "route": "cuda", "source": KERNELS[k][0],
               "replaces": KERNELS[k][1], "launches": launches[k],
               "streamed_launches": streamed.get(k, 0),
               "sharded_launches": sharded.get(k, 0),
               "multiprocess_launches": multiproc.get(k, 0),
               "touching_launches": touching.get(k, 0),
               **({"tile_launches": tile_launches[k]}
                  if k in tile_launches else {}),
               **({"passes_run": passes_ran[k]} if k in passes_ran else {}),
               **r}
              for k, r in kernels.items()]
    for k, n in tile_launches.items():
        if n == 0:
            raise AssertionError(f"main path: {k} never took the tile pass")
    if sorted(r["name"] for r in record) != sorted(KERNELS):
        raise AssertionError(f"kernel record incomplete: {record}")
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
