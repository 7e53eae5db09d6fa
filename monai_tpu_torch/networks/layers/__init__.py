from .factories import (Act, Conv, Conv3d, ConvTrans, Dropout, LayerFactory, Norm, get_act_layer,
                        get_dropout_layer, get_norm_layer, init_uniform_, linear, split_args)
from .fast_norm import InstanceNorm, instance_norm_prelu, instance_norm_prelu_plain
from .filtering import BilateralFilter, PHLFilter, TrainableBilateralFilter, TrainableJointBilateralFilter
