from tpuseg_torch.models.mednext import MedNeXt, MedNeXtConfig, build_mednext
from tpuseg_torch.models.swin_unetr import (SwinUNETR, SwinUNETRConfig,
                                            build_swin_unetr)
from tpuseg_torch.models.unet3d import UNet3D, build_model, init_weights

__all__ = ["MedNeXt", "MedNeXtConfig", "SwinUNETR", "SwinUNETRConfig",
           "UNet3D", "build_mednext", "build_model", "build_swin_unetr",
           "init_weights"]
