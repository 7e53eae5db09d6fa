from .compose import Compose, execute_compose
from .dictionary import (Activationsd, AsDiscreted, EnsureChannelFirstd, Invertd, LoadImaged, Orientationd,
                         SaveImaged, ScaleIntensityRanged, Spacingd)
from .intensity_array import ScaleIntensityRange
from .inverse import InvertibleTransform, TraceableTransform
from .io_array import LoadImage, SaveImage
from .lazy_executor import apply_pending
from .post_array import Activations, AsDiscrete
from .spatial_array import Orientation, Spacing
from .transform import LazyTransform, MapTransform, Transform, apply_transform
from .utility_array import EnsureChannelFirst
