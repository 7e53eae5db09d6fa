from .compose import Compose, execute_compose
from .croppad_array import Crop, CropForeground, RandCropByPosNegLabel, RandSpatialCrop, SpatialCrop
from .dictionary import (Activationsd, AsDiscreted, ConvertToMultiChannelBasedOnBratsClassesd, CropForegroundd,
                         EnsureChannelFirstd, Invertd, LoadImaged, NormalizeIntensityd, Orientationd,
                         RandCropByPosNegLabeld, RandFlipd, RandRotate90d, RandRotated, RandScaleIntensityd,
                         RandShiftIntensityd, RandSpatialCropd, RandZoomd, SaveImaged, ScaleIntensityd,
                         ScaleIntensityRanged, Spacingd)
from .intensity_array import (NormalizeIntensity, RandScaleIntensity, RandShiftIntensity, ScaleIntensity,
                              ScaleIntensityRange)
from .inverse import InvertibleTransform, TraceableTransform
from .io_array import LoadImage, SaveImage
from .lazy_executor import apply_pending
from .post_array import Activations, AsDiscrete
from .spatial_array import (Flip, Orientation, RandFlip, RandRotate, RandRotate90, RandZoom, Rotate, Rotate90, Spacing,
                            Zoom)
from .transform import LazyTransform, MapTransform, Randomizable, RandomizableTransform, Transform, apply_transform
from .utility_array import ConvertToMultiChannelBasedOnBratsClasses, EnsureChannelFirst
