"""Config and dtype policy. The config dataclasses are the JAX package's own
(``tpuseg.core.config`` is pure dataclasses and imports no JAX), so both
packages read one schema and one JSON format."""

from tpuseg.core.config import (
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
