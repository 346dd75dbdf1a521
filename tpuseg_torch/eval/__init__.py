"""Instance-level evaluation: the port's own copy of the JAX package's
numpy/scipy metrics (``eval/instance_f1.py``)."""

from tpuseg_torch.eval.instance_f1 import (center_match_f1, instance_metrics,
                                           voxel_metrics)

__all__ = ["center_match_f1", "instance_metrics", "voxel_metrics"]
