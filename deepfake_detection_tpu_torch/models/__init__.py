"""Model zoo of the PyTorch port.

Importing this package registers the EfficientNet (with MobileNetV3), ViT,
TimeSformer, ResNet (with gluon_resnet, res2net and sknet) and SENet
entrypoints.
"""

from ..registry import (is_model, is_model_in_modules, list_models,
                        list_modules, model_entrypoint, register_model)
from . import (efficientnet, gluon_resnet, mobilenetv3, res2net,  # noqa: F401
               resnet, senet, sknet, timesformer, vit)
from .efficientnet import EfficientNet, init_weights
from .factory import (create_deepfake_model, create_deepfake_model_v3,
                      create_deepfake_model_v4, create_model, default_cfg,
                      init_model, resolve_device)
from .helpers import load_checkpoint, load_state_dict
from .resnet import ResNet
from .senet import SENet
from .timesformer import TimeSformer
from .vit import VisionTransformer
