from .dice import DiceCELoss, DiceLoss
