"""``python -m tpuseg_torch.cli.infer`` — whole-volume instance segmentation
(port of ``tpuseg/cli/infer.py``): checkpoint in, instance-label volume
out, in one shot, streamed in z-chunks (``--stream``), sharded over a z or
(z, y) mesh (``--shard``), or streamed with each chunk sharded over y
(``--stream-shard``). Shard i sits on visible card i mod the card count
(all on one card with one), or on the CPU under ``--device cpu``; one
process runs them all. Started as N processes with the ``TPUSEG_*``
environment (``cli/common.bootstrap_runtime``), the mesh spans the
processes, each holding its own shards on its own device
(``parallel/multihost.py``); every process gets the labels, rank 0 alone
writes ``--output`` and prints the validation, and every process exits
with the same status; ``--resume-dir`` then keeps one directory per
process. Exit status 4 when ``--report-convergence`` finds the flood
truncated, 3 when ``--validate`` finds an instance in more than one piece.
"""

from __future__ import annotations

import argparse
import json
import re
import time


def _partial_path(output: str) -> str:
    """Where ``--resume-dir`` keeps the int32 labels while they stream: the
    output itself for ``.npy``, else a ``.partial.npy`` beside it."""
    return output if output.endswith(".npy") else output + ".partial.npy"


def _exists_with_shape(path: str, shape) -> bool:
    import os

    import numpy as np

    if not os.path.exists(path):
        return False
    try:
        m = np.load(path, mmap_mode="r")
        return m.shape == tuple(shape) and m.dtype == np.int32
    except (OSError, ValueError):
        return False


def calibrated(cfg, annotations: str, n_voxels: int):
    """``cfg`` calibrated from a weak-annotation npz (``--calibrate-from``)
    for a volume of ``n_voxels``: ``postproc.fg_target_fraction`` (the
    box->mask inflation correction), a per-axis ``postproc.nms_radius`` and
    the upper normalization percentile, from the instance-shape
    statistics."""
    import dataclasses

    from tpuseg_torch.data.volume_io import load_annotations
    from tpuseg_torch.ops.calibrate import (adaptive_upper_pct,
                                            expected_fg_fraction,
                                            nms_radius_from_half_sizes)

    _, half_sizes = load_annotations(annotations)
    frac = expected_fg_fraction(half_sizes, n_voxels)
    upper = adaptive_upper_pct(frac, default_upper=cfg.data.normalize_pcts[1])
    return dataclasses.replace(
        cfg,
        postproc=dataclasses.replace(
            cfg.postproc, fg_target_fraction=frac,
            nms_radius=nms_radius_from_half_sizes(half_sizes)),
        data=dataclasses.replace(
            cfg.data, normalize_pcts=(cfg.data.normalize_pcts[0], upper)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    from tpuseg_torch.cli.common import (add_config_args, load_config,
                                         load_model_state)

    add_config_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="mirror-named .pth state_dict (tpuseg.cli.export), "
                        "or a tpuseg_torch.cli.train checkpoint directory")
    p.add_argument("--input", required=True, help="volume file (npy/npz)")
    p.add_argument("--output", required=True,
                   help="instance-label volume out (npy/npz, int32)")
    p.add_argument("--no-normalize", action="store_true",
                   help="skip percentile normalization (input already in [0,1])")
    p.add_argument("--report-convergence", action="store_true",
                   help="report the watershed flood-truncation count; "
                        "nonzero exits with status 4")
    p.add_argument("--calibrate-from", default="", metavar="ANNOTATIONS_NPZ",
                   help="weak-annotation npz (centers + half_sizes): derives "
                        "postproc.fg_target_fraction (box->mask inflation "
                        "correction) and a per-axis postproc.nms_radius "
                        "(anisotropic stacks need a smaller z footprint) from "
                        "the instance-shape statistics")
    p.add_argument("--stream", type=int, default=0, metavar="CHUNK_Z",
                   help="stream the volume through the device in z-chunks of "
                        "this depth (volumes larger than device memory; an "
                        ".npy input is read from disk chunk by chunk)")
    p.add_argument("--resume-dir", default="",
                   help="with --stream: per-chunk progress checkpoints so a "
                        "killed run resumes from the first unfinished chunk "
                        "(pass the same --output; it holds finished chunks)")
    p.add_argument("--stream-shard", type=int, default=0, metavar="N",
                   help="with --stream: shard each z-chunk over y across N "
                        "shards (streamed x sharded composition)")
    p.add_argument("--shard", default="", metavar="MESH",
                   help='shard the volume over a mesh: "z8" (1-D z slabs) '
                        'or "z2,y4" (2-D z,y blocks); D and H must divide '
                        "by the axis sizes")
    p.add_argument("--validate", action="store_true",
                   help="check that every instance is one 6-connected "
                        "component (ops.labels_are_connected); a failure "
                        "exits with status 3 and writes no output")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    for flag, given in (("--resume-dir", args.resume_dir),
                        ("--stream-shard", args.stream_shard)):
        if given and not args.stream:
            p.error(f"{flag} needs --stream")
    if args.shard and args.stream:
        p.error("--shard shards a whole volume; with --stream use "
                "--stream-shard")
    mesh_spec = None
    if args.shard:
        mesh_spec = [(m.group(1), int(m.group(2)))
                     for m in re.finditer(r"([zy])(\d+)", args.shard)]
        if not mesh_spec or [a for a, _ in mesh_spec] not in (["z"],
                                                              ["z", "y"]):
            raise SystemExit(
                f'bad --shard spec {args.shard!r}: use "z8" or "z2,y4"')
    from tpuseg_torch.cli.common import bootstrap_runtime

    bootstrap_runtime(args.device)
    cfg = load_config(args)

    import os

    import numpy as np
    import torch

    from tpuseg_torch.data.volume_io import load_volume, save_volume
    from tpuseg_torch.infer import (make_infer_fn, make_sharded_infer_fn,
                                    shard_volume, stream_infer, unshard)
    from tpuseg_torch.infer.sharded import report_sharded_counts
    from tpuseg_torch.ops.merge import report_dropped, saddle_merge
    from tpuseg_torch.models import build_model
    from tpuseg_torch.parallel import Mesh
    from tpuseg_torch.parallel.mesh import place_shards
    from tpuseg_torch.parallel.multihost import (is_multiprocess,
                                                 process_device,
                                                 process_index)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    writer = process_index() == 0
    resume_dir = args.resume_dir
    if is_multiprocess():
        device = process_device(device)
        if resume_dir:
            resume_dir = os.path.join(resume_dir,
                                      f"process_{process_index()}")

    model = build_model(cfg.model)
    model.load_state_dict(load_model_state(args.checkpoint))
    model.to(device)
    if args.stream or args.shard:
        # the source dtype, from disk: read chunk by chunk or slab by slab
        volume = load_volume(args.input, mmap=True)
    else:
        volume = load_volume(args.input).astype(np.float32)

    if args.calibrate_from:
        cfg = calibrated(cfg, args.calibrate_from, volume.size)
        pp = cfg.postproc
        if writer:
            print(f"calibrated from {args.calibrate_from}: "
                  f"fg_target_fraction={pp.fg_target_fraction:.5f} "
                  f"nms_radius={pp.nms_radius} "
                  f"normalize_upper_pct={cfg.data.normalize_pcts[1]:.4f}")

    t0 = time.perf_counter()
    diag = None
    if args.stream:
        out = None
        if resume_dir:
            # a persistent int32 memmap at the output path (another rank's in
            # its resume directory) holds the finished chunks across a kill
            path = (_partial_path(args.output) if writer else
                    os.path.join(resume_dir, "labels.partial.npy"))
            os.makedirs(resume_dir, exist_ok=True)
            out = np.lib.format.open_memmap(
                path, mode="r+" if _exists_with_shape(path, volume.shape)
                else "w+", dtype=np.int32, shape=volume.shape)
        mesh = None
        if args.stream_shard:
            mesh = Mesh(place_shards(args.stream_shard, args.device), ("y",))
            print(f"--stream-shard {args.stream_shard}: {mesh}")
        stats = {}
        labels = stream_infer(model, cfg, volume, out=out,
                              chunk_z=args.stream,
                              normalize=not args.no_normalize,
                              resume_dir=resume_dir or None,
                              stats=stats, device=device, mesh=mesh)
        print("stream stats: " + json.dumps(stats))
        diag = {"flood_truncated": stats.get("flood_truncated_voxels", 0)}
    elif args.shard:
        shape = tuple(n for _, n in mesh_spec)
        mesh = Mesh(place_shards(int(np.prod(shape)), args.device),
                    tuple(a for a, _ in mesh_spec), shape)
        print(f"--shard {args.shard}: {mesh}")
        infer = make_sharded_infer_fn(model, cfg, mesh,
                                      normalize=not args.no_normalize)
        labels = unshard(infer(shard_volume(volume, mesh)), mesh)
        # the counts the call kept on the card, read after the labels
        report_sharded_counts(infer)
    else:
        infer = make_infer_fn(model, cfg, normalize=not args.no_normalize,
                              with_diagnostics=args.report_convergence)
        out = infer(torch.from_numpy(volume).to(device))
        labels, diag = out if args.report_convergence else (out, None)
        labels = labels.cpu().numpy()  # waits for the device
        if cfg.postproc.merge_saddle_ratio > 0:
            report_dropped(saddle_merge.last_dropped,
                           cfg.postproc.merge_max_pairs)
    dt = time.perf_counter() - t0

    status = 0
    if args.report_convergence and args.shard:
        print("--report-convergence: not wired for --shard "
              "(use --stream or single-device)")
    elif args.report_convergence:
        n_trunc = int(diag["flood_truncated"])
        print(f"flood convergence: TRUNCATED ({n_trunc} truncated voxels — "
              "raise postproc.flood_iters)" if n_trunc else
              "flood convergence: CONVERGED (0 truncated voxels)")
        status = 4 if n_trunc else 0

    if args.validate:
        from tpuseg_torch.ops.components import labels_are_connected

        # a streamed volume is checked chunk by chunk, as it was made
        # every process holds the labels: each checks, so all exit alike
        ok = labels_are_connected(labels, device=device,
                                  chunk_z=args.stream or None)
        if writer:
            print(f"connectivity validation: {'OK' if ok else 'FAILED'}")
        if not ok:
            return 3

    if args.stream and resume_dir and (args.output.endswith(".npy")
                                       or not writer):
        labels.flush()                 # the output memmap is the result file
    elif writer:
        save_volume(args.output, labels)
        if args.stream and resume_dir:
            os.remove(_partial_path(args.output))
    if writer:
        n = int(labels.max())
        mvox = volume.size / 1e6
        print(f"{args.input}: {volume.shape} -> {n} instances on {device} "
              f"in {dt:.2f}s ({mvox / dt:.2f} Mvox/s) -> {args.output}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
