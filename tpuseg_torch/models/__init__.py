from tpuseg_torch.models.swin_unetr import (SwinUNETR, SwinUNETRConfig,
                                            build_swin_unetr)
from tpuseg_torch.models.unet3d import UNet3D, build_model, init_weights

__all__ = ["SwinUNETR", "SwinUNETRConfig", "UNet3D", "build_model",
           "build_swin_unetr", "init_weights"]
