"""Dtype policy: fp32 params, compute in the configured dtype (bf16 by
default). Maps the config's dtype names to torch dtypes."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; expected one of {list(_DTYPES)}")
