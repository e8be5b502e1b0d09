"""Model zoo of the PyTorch port.

Importing this package registers the EfficientNet, ViT and TimeSformer
entrypoints.
"""

from ..registry import (is_model, is_model_in_modules, list_models,
                        list_modules, model_entrypoint, register_model)
from . import efficientnet, timesformer, vit  # noqa: F401  (register)
from .efficientnet import EfficientNet, init_weights
from .factory import (create_deepfake_model, create_deepfake_model_v3,
                      create_deepfake_model_v4, create_model, default_cfg,
                      init_model, resolve_device)
from .helpers import load_checkpoint, load_state_dict
from .timesformer import TimeSformer
from .vit import VisionTransformer
