from tpuseg_torch.utils.logging import MetricsLogger
from tpuseg_torch.utils.profiling import Timer, hard_sync, trace

__all__ = ["MetricsLogger", "Timer", "hard_sync", "trace"]
