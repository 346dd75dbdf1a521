"""Post-processing ops of the port: peak NMS, watershed (with the K1-K3 CUDA
kernels), size filter. See ``ops/watershed.py``."""

from tpuseg_torch.ops.filter import size_filter_and_compact
from tpuseg_torch.ops.peaks import peak_nms, radius3
from tpuseg_torch.ops.resolve import (chase_pass, chase_resolve, flood_pass,
                                      flood_resolve)
from tpuseg_torch.ops.seed import seed_chase_pass
from tpuseg_torch.ops.watershed import (flood_truncation_count,
                                        steepest_dir_codes, watershed)

#: the wrappers that launch the hand-written kernels, each with a
#: ``.launches`` counter
KERNEL_WRAPPERS = (seed_chase_pass, chase_pass, flood_pass)

__all__ = [
    "KERNEL_WRAPPERS", "chase_pass", "chase_resolve", "flood_pass",
    "flood_resolve", "flood_truncation_count", "peak_nms", "radius3",
    "seed_chase_pass", "size_filter_and_compact", "steepest_dir_codes",
    "watershed",
]
