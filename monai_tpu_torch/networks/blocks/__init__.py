from .acti_norm import ADN
from .attention import MLPBlock, PatchEmbed
from .convolutions import Convolution, ResidualUnit, same_padding, stride_minus_kernel_padding
from .crf import CRF
from .dynunet_block import (UnetBasicBlock, UnetOutBlock, UnetrBasicBlock, UnetResBlock, UnetrUpBlock,
                            get_conv_layer)
