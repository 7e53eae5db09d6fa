from .segresnet import SegResNet
from .swin_unetr import SwinUNETR
from .unet import SkipConnection, UNet, Unet
