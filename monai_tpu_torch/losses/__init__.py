from .dice import DiceCELoss, DiceLoss
from .other import CrossEntropyLoss
