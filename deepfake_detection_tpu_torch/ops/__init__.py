"""Ops/layers of the PyTorch port (counterpart of ``deepfake_detection_tpu/ops``)."""

from .activations import ACT_FNS, get_act_fn, hard_mish, hard_sigmoid, hard_swish, mish, swish
from .conv import (Conv2d, conv_kernel_init_goog, create_conv2d,
                   dense_init_goog, explicit_padding, resolve_padding)
from .depthwise import (FUSED_DW_ACTS, fused_depthwise,
                        fused_depthwise_reference)
from .drop import DropPath, drop_path, dropout
from .norm import (BN_EPS_PT_DEFAULT, BN_EPS_TF_DEFAULT,
                   BN_MOMENTUM_PT_DEFAULT, BN_MOMENTUM_TF_DEFAULT,
                   BatchNorm2d, resolve_bn_args)
from .pool import SelectAdaptivePool2d, adaptive_pool_feat_mult, global_pool_nchw
