from tpuseg_torch.infer.pipeline import (infer_volume, make_batched_infer_fn,
                                         make_infer_fn, make_infer_stages)
from tpuseg_torch.infer.sharded import (make_sharded_infer_fn, shard_volume,
                                        unshard)
from tpuseg_torch.infer.streaming import stream_infer
from tpuseg_torch.infer.tiles import (halo3, measure_rf_radius, rf_radius_bound,
                                      tile_grid, tiled_forward)
from tpuseg_torch.parallel.mesh import make_z_mesh, make_zy_mesh

__all__ = ["halo3", "infer_volume", "make_batched_infer_fn", "make_infer_fn",
           "make_infer_stages", "make_sharded_infer_fn", "make_z_mesh",
           "make_zy_mesh", "measure_rf_radius", "rf_radius_bound",
           "shard_volume", "stream_infer", "tile_grid", "tiled_forward",
           "unshard"]
