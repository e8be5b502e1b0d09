"""Model factory.

Counterpart of ``deepfake_detection_tpu/models/factory.py``: ``create_model``
plus the three deepfake wrappers that differ only in defaults.  Where the
JAX package returns an architecture and builds parameters separately with
``init_model``, here ``create_model`` returns a module whose weights are
already made by :func:`init_model`: seeded construction on a device.

Entry points default to ``device="cuda"`` and raise when CUDA is missing
unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn as nn

from ..registry import model_entrypoint
from .efficientnet import init_weights

__all__ = ["resolve_device", "create_model", "create_deepfake_model",
           "create_deepfake_model_v3", "create_deepfake_model_v4",
           "init_model"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none:
    the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' for the plain "
                           "PyTorch path")
    return dev


def init_model(model: nn.Module, seed: int = 0,
               device: Union[str, torch.device] = "cuda") -> nn.Module:
    """Seeded weights (a CPU ``torch.Generator``, so a seed gives the same
    weights on every device), then ``model`` moved to ``device`` in
    channels_last memory, in eval mode."""
    dev = resolve_device(device)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def create_model(model_name: str, pretrained: bool = False,
                 num_classes: int = 1000, in_chans: int = 3,
                 checkpoint_path: str = "",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 **kwargs) -> nn.Module:
    """Build a registered model with seeded weights on ``device``, loading
    ``checkpoint_path`` (strict) when given.  Keyword arguments set to None
    take the model's default."""
    resolve_device(device)
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    model = model_entrypoint(model_name)(pretrained=pretrained,
                                         num_classes=num_classes,
                                         in_chans=in_chans, **kwargs)
    model = init_model(model, seed, device)
    if checkpoint_path:
        from .helpers import load_checkpoint
        load_checkpoint(model, checkpoint_path)
    return model


def create_deepfake_model(model_name: str = "efficientnet_b7_deepfake",
                          pretrained: bool = False, num_classes: int = 2,
                          in_chans: int = 3, **kwargs) -> nn.Module:
    """Deepfake default wrapper: num_classes=2."""
    return create_model(model_name, pretrained=pretrained,
                        num_classes=num_classes, in_chans=in_chans, **kwargs)


def create_deepfake_model_v3(model_name: str = "efficientnet_deepfake_v3",
                             pretrained: bool = False, num_classes: int = 2,
                             in_chans: int = 12, **kwargs) -> nn.Module:
    """v3 wrapper; builds only ``efficientnet_deepfake_v3``."""
    if model_name != "efficientnet_deepfake_v3":
        raise ValueError("create_deepfake_model_v3 only builds "
                         f"efficientnet_deepfake_v3, got {model_name!r}")
    return create_model(model_name, pretrained=pretrained,
                        num_classes=num_classes, in_chans=in_chans, **kwargs)


def create_deepfake_model_v4(model_name: str = "efficientnet_deepfake_v4",
                             pretrained: bool = False, num_classes: int = 2,
                             in_chans: int = 12, **kwargs) -> nn.Module:
    """v4 wrapper; builds only ``efficientnet_deepfake_v4``."""
    if model_name != "efficientnet_deepfake_v4":
        raise ValueError("create_deepfake_model_v4 only builds "
                         f"efficientnet_deepfake_v4, got {model_name!r}")
    return create_model(model_name, pretrained=pretrained,
                        num_classes=num_classes, in_chans=in_chans, **kwargs)
