from tpuseg_torch.models.unet3d import UNet3D, build_model, init_weights

__all__ = ["UNet3D", "build_model", "init_weights"]
