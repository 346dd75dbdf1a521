"""Config and dtype policy. The config dataclasses are the port's own copy
(``core/config.py``) of the JAX package's: same fields, defaults and JSON
format, so one config file serves both packages."""

from tpuseg_torch.core.config import (
    Config,
    DataConfig,
    InferConfig,
    ModelConfig,
    PostprocConfig,
    TrainConfig,
)

__all__ = [
    "Config",
    "DataConfig",
    "InferConfig",
    "ModelConfig",
    "PostprocConfig",
    "TrainConfig",
]
