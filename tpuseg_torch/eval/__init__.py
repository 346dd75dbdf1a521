"""Instance-level evaluation: the JAX package's numpy/scipy metrics
(``tpuseg.eval.instance_f1`` imports no JAX), shared as they are."""

from tpuseg.eval.instance_f1 import (center_match_f1, instance_metrics,
                                     voxel_metrics)

__all__ = ["center_match_f1", "instance_metrics", "voxel_metrics"]
