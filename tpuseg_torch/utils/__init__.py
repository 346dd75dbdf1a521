from tpuseg_torch.utils.logging import MetricsLogger
from tpuseg_torch.utils.profiling import hard_sync, trace

__all__ = ["MetricsLogger", "hard_sync", "trace"]
