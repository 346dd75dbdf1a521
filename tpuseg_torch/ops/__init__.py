"""Ops of the port: peak NMS (with the K5 CUDA kernel, ``ops/nms.py``),
watershed (with the K1-K3 kernels; see ``ops/watershed.py``), saddle merge,
connected components, instance sizes and the size filter, compact relabel,
the histograms of one-volume inference (H1-H3, ``ops/hist.py``), the
saddle merge's pair table (M1, M2, ``ops/merge.py``), the union-find
closure of the merge and the sharded paths (U1, ``ops/closure.py``), the
fused eval ConvBlock (K4, ``ops/convblock.py``), the decoder's
upsample-and-conv with its skip concatenation (``ops/upconv.py``), the
training path's 3x3x3 conv (K6, ``ops/convtrain.py``), whose bf16 bodies
share the weight layout of ``ops/conv_mma.py``, and SwinUNETR's
shifted-window attention (W1, ``ops/window_attn.py``), its ResBlocks'
InstanceNorm, add and LeakyReLU (N1, ``ops/instnorm.py``; MedNeXt's
GroupNorm too) and their 3x3x3 convs (R1, ``ops/rconv.py``), and MedNeXt's
depthwise convs (D1, ``ops/dwconv.py``)."""

from tpuseg_torch.ops.closure import union_closure, union_closure_plain
from tpuseg_torch.ops.convblock import (fold_bn_affine, fused_convblock,
                                        fused_convblock_plain)
from tpuseg_torch.ops.convtrain import conv3x3, conv3x3_plain, conv3x3_raw
# the module keeps its name: the package attribute ``dwconv`` is
# ops/dwconv.py
from tpuseg_torch.ops.dwconv import dwconv as _dwconv
from tpuseg_torch.ops.dwconv import dwconv_plain
from tpuseg_torch.ops.components import (connected_components,
                                         label_components,
                                         labels_are_connected)
from tpuseg_torch.ops.filter import (label_sizes, max_seed_count, size_filter,
                                     size_filter_and_compact)
from tpuseg_torch.ops.hist import bin_counts, label_counts, percentiles
from tpuseg_torch.ops.instnorm import (instance_norm_lrelu,
                                       instance_norm_lrelu_plain)
from tpuseg_torch.ops.merge import LAST_CALL_STATE as _MERGE_STATE
from tpuseg_torch.ops.merge import (apply_merge_table, pair_aggregate,
                                    pair_slots, saddle_merge,
                                    saddle_merge_edges, saddle_merge_table)
from tpuseg_torch.ops.nms import fused_peak_nms
from tpuseg_torch.ops.peaks import peak_nms, radius3, seed_labels_from_peaks
from tpuseg_torch.ops.rconv import channel_product, rconv_plain
# the module keeps its name: the package attribute ``rconv`` is ops/rconv.py
from tpuseg_torch.ops.rconv import rconv as _rconv
from tpuseg_torch.ops.relabel import compact_relabel
from tpuseg_torch.ops.resolve import LAST_CALL_STATE as _RESOLVE_STATE
from tpuseg_torch.ops.resolve import (chase_pass, chase_resolve, flood_pass,
                                      flood_resolve)
from tpuseg_torch.ops.seed import seed_chase_pass
from tpuseg_torch.ops.upconv import upsample_conv_cat, upsample_conv_cat_plain
from tpuseg_torch.ops.watershed import (ascent_labels,
                                        flood_truncation_count,
                                        steepest_dir_codes, watershed)
from tpuseg_torch.ops.window_attn import (window_attention,
                                          window_attention_plain)

#: the wrappers that launch the hand-written kernels, each with a
#: ``.launches`` counter
KERNEL_WRAPPERS = (seed_chase_pass, chase_pass, flood_pass, conv3x3_raw,
                   fused_convblock, fused_peak_nms, bin_counts, percentiles,
                   label_counts, union_closure, pair_aggregate, pair_slots,
                   upsample_conv_cat, window_attention, instance_norm_lrelu,
                   _rconv, _dwconv)

#: the state the wrappers keep about their last call, ``(holder,
#: attribute)``, declared by each wrapper's module
LAST_CALL_STATE = _RESOLVE_STATE + _MERGE_STATE

__all__ = [
    "KERNEL_WRAPPERS", "LAST_CALL_STATE", "apply_merge_table",
    "ascent_labels", "bin_counts",
    "chase_pass",
    "chase_resolve", "compact_relabel", "connected_components", "conv3x3",
    "conv3x3_plain", "conv3x3_raw", "dwconv_plain", "flood_pass",
    "flood_resolve",
    "flood_truncation_count", "fold_bn_affine", "fused_convblock",
    "fused_convblock_plain", "fused_peak_nms", "instance_norm_lrelu",
    "instance_norm_lrelu_plain", "label_components",
    "label_counts", "label_sizes", "labels_are_connected", "max_seed_count",
    "pair_aggregate", "pair_slots", "peak_nms", "percentiles",
    "radius3", "saddle_merge", "saddle_merge_edges", "saddle_merge_table",
    "seed_chase_pass", "seed_labels_from_peaks", "size_filter",
    "size_filter_and_compact", "steepest_dir_codes", "union_closure",
    "union_closure_plain", "upsample_conv_cat", "upsample_conv_cat_plain",
    "watershed", "window_attention", "window_attention_plain",
]
