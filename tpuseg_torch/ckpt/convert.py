"""Weights into the port (the counterpart of ``tpuseg/ckpt/torch_import.py``).

The port's U-Net uses the module and parameter names of
``tpuseg/ckpt/torch_mirror.py``, so its state is a mirror ``state_dict``
without ``num_batches_tracked``:

  JAX variable path                 port key                    transform
  params/<m>/kernel              -> <m>.weight                  DHWIO -> OIDHW
  params/<m>/scale | bias        -> <m>.weight | <m>.bias       copy
  batch_stats/<m>/mean | var     -> <m>.running_mean | _var     copy

Eval BatchNorm folds the statistics into its per-channel affine when it runs
(``models/blocks.EvalBatchNorm``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def port_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` (numpy arrays) as a
    ``state_dict`` for :class:`tpuseg_torch.models.UNet3D`."""
    leaf_names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})).items():
            *mods, leaf = path
            v = np.array(v, np.float32)    # copy: jax exports are read-only
            if leaf == "kernel":           # (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
                v = np.ascontiguousarray(np.transpose(v, (4, 3, 0, 1, 2)))
                name = "weight"
            elif leaf in leaf_names:
                name = leaf_names[leaf]
            else:
                raise ValueError(f"unexpected variable leaf {'/'.join(path)}")
            sd[".".join(mods) + "." + name] = torch.from_numpy(v)
    return sd


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A mirror-named ``.pth`` (a ``state_dict`` or ``{"state_dict": ...}``,
    as ``tpuseg.cli.export`` writes) as a port ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.float() for k, v in obj.items()
            if not k.endswith("num_batches_tracked")}
