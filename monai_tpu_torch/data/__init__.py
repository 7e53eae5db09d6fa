from .image_reader import NiftiReader
from .meta_image import MetaImage
from .nifti import read_nifti, write_nifti
from .utils import compute_importance_map, dense_patch_slices, get_valid_patch_size
