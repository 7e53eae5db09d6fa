from .acti_norm import ADN
from .attention import (CrossAttentionBlock, MLPBlock, PatchEmbed, PatchEmbeddingBlock, SABlock,
                        TransformerBlock)
from .convolutions import Convolution, ResidualUnit, same_padding, stride_minus_kernel_padding
from .crf import CRF
from .segresnet_block import ResBlock, get_upsample_layer
from .dynunet_block import (UnetBasicBlock, UnetOutBlock, UnetrBasicBlock, UnetResBlock, UnetrPrUpBlock, UnetrUpBlock,
                            UnetUpBlock, get_conv_layer)
from .upsample import SubpixelUpsample, UpSample, interpolate
