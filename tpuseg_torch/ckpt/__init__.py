from tpuseg_torch.ckpt.convert import (jax_variables_from_port, load_pth,
                                       port_state_from_jax)
from tpuseg_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager", "jax_variables_from_port", "load_pth",
           "port_state_from_jax"]
