from .factories import (Act, Conv, Conv3d, ConvTrans, Dropout, LayerFactory, Norm, Pool, get_act_layer,
                        get_dropout_layer, get_norm_layer, get_pool_layer, init_uniform_, linear, split_args)
from .fast_norm import InstanceNorm, instance_norm_prelu, instance_norm_prelu_plain
from .filtering import BilateralFilter, PHLFilter, TrainableBilateralFilter, TrainableJointBilateralFilter
from .gmm import GaussianMixtureModel
from .spatial_transforms import (AffineTransform, grid_count, grid_grad, grid_pull, grid_push, normalize_transform,
                                 to_norm_affine)
