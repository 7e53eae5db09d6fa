from .unet import SkipConnection, UNet, Unet
