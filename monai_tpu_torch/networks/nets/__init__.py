from .densenet import (DenseNet, DenseNet121, DenseNet169, DenseNet201, DenseNet264, densenet121, densenet169,
                       densenet201, densenet264)
from .dynunet import DynUNet, DynUNetSkipLayer
from .segresnet import SegResNet, SegResNetVAE
from .swin_unetr import SwinUNETR
from .unet import SkipConnection, UNet, Unet
from .unetr import UNETR
from .vit import ViT, ViTAutoEnc
