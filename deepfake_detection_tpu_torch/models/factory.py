"""Model factory.

Counterpart of ``deepfake_detection_tpu/models/factory.py``: ``create_model``
plus the three deepfake wrappers that differ only in defaults.  Where the
JAX package returns an architecture and builds parameters separately with
``init_model``, here ``create_model`` returns a module whose weights are
already made by :func:`init_model`: seeded construction on a device.

The JAX factory's family rules hold: the BN keyword arguments reach only
the EfficientNet family; ``attn_impl`` is checked against the five impls
and reaches only ViT and TimeSformer (dropped with a warning elsewhere);
``drop_connect_rate`` maps onto ``drop_path_rate``.  ``img_size``, which the
transformers need to size their position embeddings (the JAX modules size
them from the first input), reaches only them.

``dtype`` (every family) is the JAX factory's compute dtype
(:func:`helpers.set_compute_dtype`); None keeps f32.

Entry points default to ``device="cuda"`` and raise when CUDA is missing
unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from ..registry import is_model, is_model_in_modules, model_entrypoint
from . import efficientnet, timesformer, vit
from .helpers import load_checkpoint, set_compute_dtype

__all__ = ["resolve_device", "create_model", "create_deepfake_model",
           "create_deepfake_model_v3", "create_deepfake_model_v4",
           "init_model", "default_cfg"]

_logger = logging.getLogger(__name__)

# modules whose generators understand the BN keyword arguments
_BN_KWARG_MODULES = ("efficientnet",)
# modules with a pluggable attention kernel (and learned position embeddings)
_ATTN_MODULES = ("vit", "timesformer")
# model class → seeded init, and whether its convs run in channels_last
_INITS = {efficientnet.EfficientNet: (efficientnet.init_weights, True),
          vit.VisionTransformer: (vit.init_weights, False),
          timesformer.TimeSformer: (timesformer.init_weights, False)}


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
    weights on every device), then ``model`` moved to ``device`` (an
    EfficientNet in channels_last memory), in eval mode."""
    dev = resolve_device(device)
    init, channels_last = _INITS[type(model)]
    init(model, torch.Generator().manual_seed(seed))
    if not channels_last:
        return model.to(device=dev).eval()
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def default_cfg(model_name: str) -> Dict[str, Any]:
    """The registered model's ``default_cfg`` (input size, mean, std, ...)
    without building it; TimeSformer's is for its default 12 channels."""
    for module in (efficientnet, vit, timesformer):
        if model_name in module.default_cfgs:
            return module.default_cfgs[model_name]
    raise KeyError(f"Unknown model {model_name!r}")


def _family_kwargs(model_name: str, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX factory's family rules (see the module docstring)."""
    if not is_model(model_name):
        raise KeyError(f"Unknown model {model_name!r}")
    if not is_model_in_modules(model_name, _BN_KWARG_MODULES):
        for k in ("bn_tf", "bn_momentum", "bn_eps"):
            kwargs.pop(k, None)
    if (ai := kwargs.get("attn_impl")) is not None:
        if ai not in vit.ATTN_IMPLS:   # a typo must not become dense
            raise ValueError(f"attn_impl={ai!r}: expected one of "
                             f"{vit.ATTN_IMPLS}")
        if not is_model_in_modules(model_name, _ATTN_MODULES):
            kwargs.pop("attn_impl")
            _logger.warning("attn_impl=%r is only consumed by the %s "
                            "families; ignored for %s", ai, _ATTN_MODULES,
                            model_name)
    if not is_model_in_modules(model_name, _ATTN_MODULES):
        kwargs.pop("img_size", None)
    if is_model_in_modules(model_name, ("timesformer",)):
        # the JAX TimeSformer takes neither (its runner's build of one
        # fails on them, ROADMAP Queue 3): it has no dropout and pools by
        # the mean over frames and patches
        if kwargs.pop("drop_rate", None):
            raise ValueError(f"{model_name} has no dropout (drop_rate)")
        if kwargs.pop("global_pool", None) not in (None, "avg"):
            raise ValueError(f"{model_name} pools by the mean only")
    dcr = kwargs.pop("drop_connect_rate", None)
    if dcr is not None and kwargs.get("drop_path_rate") is None:
        kwargs["drop_path_rate"] = dcr
    return {k: v for k, v in kwargs.items() if v is not None}


def create_model(model_name: str, pretrained: bool = False,
                 num_classes: int = 1000, in_chans: int = 3,
                 checkpoint_path: str = "",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 dtype: Optional[torch.dtype] = None,
                 **kwargs) -> nn.Module:
    """Build a registered model with seeded weights on ``device``, loading
    ``checkpoint_path`` (strict) when given, after the family rules;
    keyword arguments set to None take the model's default; ``dtype`` is
    the compute dtype."""
    resolve_device(device)
    kwargs = _family_kwargs(model_name, dict(kwargs))
    model = model_entrypoint(model_name)(pretrained=pretrained,
                                         num_classes=num_classes,
                                         in_chans=in_chans, **kwargs)
    model = set_compute_dtype(init_model(model, seed, device), dtype)
    if checkpoint_path:
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
