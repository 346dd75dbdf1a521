from tpuseg_torch.infer.pipeline import make_infer_fn, make_infer_stages
from tpuseg_torch.infer.tiles import halo3, rf_radius_bound, tile_grid, tiled_forward

__all__ = ["halo3", "make_infer_fn", "make_infer_stages", "rf_radius_bound",
           "tile_grid", "tiled_forward"]
