"""Model states the benchmark makes: seeded initial weights, and the
trained weights of the inference configurations.

:func:`init_state` draws a U-Net's state dict on the device from a seed in
one call: LeCun-normal conv kernels, zero biases, BatchNorm affines (1, 0)
and initial running statistics (0, 1), in the program's parameter names.

:func:`trained_state` is a configuration's ``weights`` recipe (steps,
learning rate, warmup, augmentation, volumes, seed) run by the reference
trainer (``reference/train.py``) from :func:`init_state`, so the inference
cells' weights come from the benchmark and not from the program under
test. The recipe runs once per checkout, in the first run of a cell, with
TF32 convolutions (weights are an input here, not a check); the state is
kept in ``.cache/weights/`` under a hash of the recipe and of the sources
that make it, and later runs load it.
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np
import torch

from perfbench import cells, gen, work


def state_shapes(model: dict) -> dict:
    """Parameter and buffer name -> shape, the program's names."""
    out = {}
    for name, k, ci, co, _ in work.unet_convs(model["features"],
                                               model["in_channels"],
                                               model["head_features"]):
        out[f"{name}.weight"] = (co, ci, k, k, k)
        block, _, conv = name.rpartition(".")
        if conv in ("conv0", "conv1"):
            norm = f"{block}.norm{conv[-1]}"
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{norm}.{leaf}"] = (co,)
        else:
            out[f"{name}.bias"] = (co,)
    return out


def init_state(model: dict, seed: int, device) -> dict:
    shapes = state_shapes(model)
    kernels = [k for k in shapes if len(shapes[k]) == 5]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(math.prod(shapes[k]) for k in kernels),
                       generator=g, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if len(shape) == 5:
            n = math.prod(shape)
            out[k] = flat[at:at + n].view(shape) / math.sqrt(
                math.prod(shape[1:]))
            at += n
        elif k.endswith(("weight", "running_var")):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def _recipe_key(config: dict) -> str:
    h = hashlib.sha256(json.dumps([config["model"], config["weights"]],
                                  sort_keys=True).encode())
    for src in ("weights.py", "gen.py", "reference/train.py",
                "reference/unet.py"):
        h.update((cells.HERE / src).read_bytes())
    return h.hexdigest()[:16]


def trained_state(config: dict, device) -> dict:
    """The configuration's trained state dict on ``device``, made and kept
    at the first call in a checkout, loaded from the cache after."""
    path = cells.CACHE / "weights" / f"{config['name']}-{_recipe_key(config)}.pt"
    if not path.exists():
        _train(config, device, path)
    return torch.load(path, map_location=device)


def _train(config: dict, device, path) -> None:
    from perfbench.reference.train import Trainer

    r = config["weights"]
    state = init_state(config["model"], r["seed"], device)
    vols = [gen.Volume(v.image.cpu().numpy(), v.centers, v.half_sizes)
            for v in gen.make_volumes(r["volumes"], r["seed"], device)]
    trainer = Trainer(state, {"model": config["model"], "data": r["data"],
                              "train": r["train"]}, device)
    rng = np.random.default_rng(r["seed"])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for _ in range(r["steps"]):
            trainer.step(gen.sample_patches(vols, r["data"]["patch_size"],
                                            r["data"]["batch_size"],
                                            r["data"]["max_instances"], rng),
                         r["seed"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    torch.save({k: v.detach().cpu() for k, v in {**trainer.params,
                                                 **trainer.stats}.items()},
               tmp)
    os.replace(tmp, path)
