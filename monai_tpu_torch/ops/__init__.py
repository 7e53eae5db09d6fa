from .conv3d import conv3d_3x3_same, conv3d_3x3_same_plain
from .window_attention import fused_window_attention, fused_window_attention_plain
from .separable_resample import separable_resample_3d, separable_resample_3d_plain
from .bilateral import bilateral_stencil, bilateral_stencil_plain
from .filtering import bilateral_filter, bilateral_grid_filter, phl_filter
