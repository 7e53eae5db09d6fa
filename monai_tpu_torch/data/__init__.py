from .utils import compute_importance_map, dense_patch_slices, get_valid_patch_size
