"""Data side of the port: volume I/O, synthetic fixtures, patch sampling,
normalization, weak targets, augmentation, prefetch."""

from tpuseg_torch.data.normalize import (histogram_percentile_normalize,
                                         histogram_percentile_scalars,
                                         percentile_normalize)
from tpuseg_torch.data.sampler import PatchSampler
from tpuseg_torch.data.synthetic import (SyntheticVolume,
                                         synthesize_touching_volume,
                                         synthesize_volume)
from tpuseg_torch.data.volume_io import (load_annotations, load_volume,
                                         save_annotations, save_volume)
from tpuseg_torch.data.weak_targets import make_weak_targets

__all__ = ["PatchSampler", "SyntheticVolume",
           "histogram_percentile_normalize", "histogram_percentile_scalars",
           "load_annotations", "load_volume", "make_weak_targets",
           "percentile_normalize", "save_annotations", "save_volume",
           "synthesize_touching_volume", "synthesize_volume"]
