from .compose import Compose, execute_compose
from .croppad_array import Crop, CropForeground, RandCropByPosNegLabel, RandSpatialCrop, SpatialCrop
from .dictionary import (Activationsd, AsDiscreted, ConvertToMultiChannelBasedOnBratsClassesd, CropForegroundd,
                         EnsureChannelFirstd, Invertd, LoadImaged, NormalizeIntensityd, Orientationd,
                         RandCropByPosNegLabeld, RandFlipd, RandRotate90d, RandScaleIntensityd, RandShiftIntensityd,
                         RandSpatialCropd, SaveImaged, ScaleIntensityRanged, Spacingd)
from .intensity_array import NormalizeIntensity, RandScaleIntensity, RandShiftIntensity, ScaleIntensityRange
from .inverse import InvertibleTransform, TraceableTransform
from .io_array import LoadImage, SaveImage
from .lazy_executor import apply_pending
from .post_array import Activations, AsDiscrete
from .spatial_array import Flip, Orientation, RandFlip, RandRotate90, Rotate90, Spacing
from .transform import LazyTransform, MapTransform, Randomizable, RandomizableTransform, Transform, apply_transform
from .utility_array import ConvertToMultiChannelBasedOnBratsClasses, EnsureChannelFirst
