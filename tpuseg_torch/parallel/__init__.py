"""Shard meshes, halo exchange, cross-shard label reconciliation and the
multi-process runtime of the sharded and data-parallel paths (port of
``tpuseg/parallel``)."""

from tpuseg_torch.parallel.halo import exchange_halo, exchange_z_halo
from tpuseg_torch.parallel.mesh import Mesh, make_z_mesh, make_zy_mesh
from tpuseg_torch.parallel.reconcile import (global_compact_labels,
                                             merge_boundary_labels)

__all__ = ["Mesh", "exchange_halo", "exchange_z_halo", "global_compact_labels",
           "make_z_mesh", "make_zy_mesh", "merge_boundary_labels"]
