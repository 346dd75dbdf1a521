"""Data side of the port: volume I/O, synthetic fixtures, normalization."""

from tpuseg_torch.data.normalize import histogram_percentile_scalars
from tpuseg_torch.data.synthetic import SyntheticVolume, synthesize_volume
from tpuseg_torch.data.volume_io import load_volume, save_volume

__all__ = ["SyntheticVolume", "histogram_percentile_scalars", "load_volume",
           "save_volume", "synthesize_volume"]
