"""The trained weights of the inference configurations.

A configuration's seeded initial state is its architecture's
(``arch/<name>.py``: ``init_state``, with the names and the draw of that
architecture). :func:`trained_state` is a configuration's ``weights``
recipe (steps, learning rate, warmup, augmentation, volumes, seed) run by
the reference trainer (``reference/train.py``) from that initial state, so
the inference cells' weights come from the benchmark and not from the
program under test. The recipe runs once per checkout, in the first run of
a cell, with TF32 convolutions (weights are an input here, not a check);
the state is kept in ``.cache/weights/`` under a hash of the recipe and of
the sources that make it (this file, the generators', the reference
trainer and the architecture's ``SOURCES``), and later runs load it.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from perfbench import cells, gen


def _recipe_key(config: dict) -> str:
    h = hashlib.sha256(json.dumps([config["model"], config["weights"]],
                                  sort_keys=True).encode())
    arch = cells.load_arch(cells.arch_name(config))
    vols = config["weights"]["volumes"]
    for src in ("weights.py", "gen.py", "reference/train.py",
                f"generators/{gen.generator(vols)}.py", *arch.SOURCES):
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
    arch = cells.load_arch(cells.arch_name(config))
    state = arch.init_state(config["model"], r["seed"], device)
    vols = [gen.Volume(v.image.cpu().numpy(), v.centers, v.half_sizes)
            for v in gen.volumes_for(r["volumes"], r["seed"], device)]
    trainer = Trainer(arch, state, {"model": config["model"],
                                    "data": r["data"], "train": r["train"]},
                      device)
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
