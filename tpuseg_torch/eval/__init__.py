"""Instance-level evaluation: the JAX package's numpy/scipy metrics
(``tpuseg.eval.instance_f1`` imports no JAX), shared as they are."""

from tpuseg.eval.instance_f1 import instance_metrics, voxel_metrics

__all__ = ["instance_metrics", "voxel_metrics"]
