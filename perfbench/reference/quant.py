"""The lower precisions the controls compute in.

Both configurations state bf16 compute, so their controls are the reference
with every conv's input and kernel rounded to fp8 (e4m3, the format an H100
computes fp8 products in), each tensor scaled by its own absolute maximum
first, as fp8 inference and training do. Under autograd the rounding passes
the gradient straight through, so the backward computes with the rounded
operands the forward saved.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to per-tensor-scaled fp8 e4m3, back in x's dtype."""
    with torch.no_grad():
        scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach() if x.requires_grad else q

