from tpuseg_torch.ckpt.convert import load_pth, port_state_from_jax

__all__ = ["load_pth", "port_state_from_jax"]
