from .acti_norm import ADN
from .convolutions import Convolution, ResidualUnit, same_padding, stride_minus_kernel_padding
