from .compose import Compose, OneOf, RandomOrder, SomeOf, execute_compose
from .croppad_array import Crop, CropForeground, RandCropByPosNegLabel, RandSpatialCrop, SpatialCrop
from .dictionary import (Activationsd, AsDiscreted, ConvertToMultiChannelBasedOnBratsClassesd, CropForegroundd,
                         EnsureChannelFirstd, FgBgToIndicesd, Invertd, LoadImaged, MeanEnsembled, NormalizeIntensityd, Orientationd,
                         RandCropByPosNegLabeld, RandFlipd, RandRotate90d, RandRotated, RandScaleIntensityd,
                         RandShiftIntensityd, RandSpatialCropd, RandZoomd, Resized, SaveImaged, ScaleIntensityd,
                         ScaleIntensityRanged, Spacingd, VoteEnsembled)
from .intensity_array import (NormalizeIntensity, RandScaleIntensity, RandShiftIntensity, ScaleIntensity,
                              ScaleIntensityRange)
from .inverse import InvertibleTransform, TraceableTransform
from .io_array import LoadImage, SaveImage
from .lazy_executor import apply_pending
from .post_array import Activations, AsDiscrete, MeanEnsemble, VoteEnsemble
from .spatial_array import (Flip, Orientation, RandFlip, RandRotate, RandRotate90, RandZoom, Resize, Rotate, Rotate90,
                            Spacing, SpatialResample, Zoom)
from .transform import LazyTransform, MapTransform, Randomizable, RandomizableTransform, Transform, apply_transform
from .utility_array import ConvertToMultiChannelBasedOnBratsClasses, EnsureChannelFirst, FgBgToIndices
