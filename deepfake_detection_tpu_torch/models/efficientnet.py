"""EfficientNet family (PyTorch, NCHW in channels_last memory).

Counterpart of ``deepfake_detection_tpu/models/efficientnet.py`` for the
compound-scaled B0–B8 and the deepfake configs ``efficientnet_b7_deepfake``,
``efficientnet_deepfake_v3`` and the flagship ``efficientnet_deepfake_v4``
(12 input channels = 4 RGB frames, 600², B7 width/depth scaling with stem
256 and head 256, Swish, SE).  Module and parameter names are timm's:
``conv_stem``, ``bn1``, ``blocks.{stage}.{block}.*``, ``conv_head``,
``bn2``, ``classifier``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops.activations import get_act_fn
from ..ops.conv import Conv2d, dense_init_goog
from ..ops.drop import dropout
from ..ops.linear import Linear
from ..ops.norm import BatchNorm2d, resolve_bn_args
from ..ops.pool import SelectAdaptivePool2d
from ..registry import register_model
from .efficientnet_blocks import (ConvBnAct, DepthwiseSeparableConv,
                                  InvertedResidual, _norm, round_channels)
from .efficientnet_builder import build_block_configs, decode_arch_def

__all__ = ["EfficientNet", "init_weights"]

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def _cfg(url: str = "", **kwargs) -> Dict[str, Any]:
    cfg = dict(url=url, num_classes=1000, input_size=(3, 224, 224),
               pool_size=(7, 7), crop_pct=0.875, interpolation="bicubic",
               mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
               first_conv="conv_stem", classifier="classifier")
    cfg.update(kwargs)
    return cfg


default_cfgs: Dict[str, Dict[str, Any]] = {
    **{f"efficientnet_b{i}": _cfg(input_size=(3, r, r))
       for i, r in enumerate([224, 240, 260, 300, 380, 456, 528, 600, 672])},
    "efficientnet_b7_deepfake": _cfg(input_size=(3, 450, 800), num_classes=2),
    "efficientnet_deepfake_v3": _cfg(input_size=(12, 600, 600), num_classes=2),
    "efficientnet_deepfake_v4": _cfg(input_size=(12, 600, 600), num_classes=2),
}

_BLOCK_TYPES = {
    "ir": InvertedResidual,
    "ds": DepthwiseSeparableConv,
    "cn": ConvBnAct,
}


class EfficientNet(nn.Module):
    """Generic EfficientNet: stem conv → blocks → 1×1 head conv → BN → act →
    global pool → classifier.  ``block_configs`` comes from
    :func:`build_block_configs`."""

    def __init__(self, block_configs, num_classes: int = 1000,
                 num_features: int = 1280, in_chans: int = 3,
                 stem_size: int = 32, act: Any = "relu",
                 drop_rate: float = 0.0, global_pool: str = "avg",
                 se_kwargs: Any = None, norm_layer: str = "bn",
                 pad_type: str = "", bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5, default_cfg: Optional[dict] = None):
        super().__init__()
        self.in_chans = in_chans
        self.drop_rate = drop_rate
        self.default_cfg = default_cfg
        self.act_fn = get_act_fn(act)
        bnk = dict(norm_layer=norm_layer, bn_momentum=bn_momentum,
                   bn_eps=bn_eps)
        self.conv_stem = Conv2d(in_chans, stem_size, 3, stride=2,
                                padding=pad_type)
        self.bn1 = _norm(norm_layer, stem_size, bn_momentum, bn_eps)
        chs = stem_size
        stages = []
        for stage in block_configs:
            blocks = []
            for cfg in stage:
                cfg = dict(cfg)
                btype = cfg.pop("block_type")
                if pad_type:
                    cfg["pad_type"] = pad_type
                block_act = cfg.pop("act", act)
                if btype == "cn":
                    for k in ("noskip", "dw_kernel_size", "se_ratio",
                              "drop_path_rate"):
                        cfg.pop(k, None)
                elif se_kwargs is not None:
                    cfg.setdefault("se_kwargs", se_kwargs)
                if btype not in _BLOCK_TYPES:
                    raise NotImplementedError(
                        f"block type {btype!r} is not ported")
                block = _BLOCK_TYPES[btype](chs, **cfg, **bnk, act=block_act)
                chs = block.out_chs
                blocks.append(block)
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = Conv2d(chs, num_features, 1, padding=pad_type)
        self.bn2 = _norm(norm_layer, num_features, bn_momentum, bn_eps)
        self.global_pool = SelectAdaptivePool2d(global_pool)
        self.classifier = (Linear(num_features
                                     * self.global_pool.feat_mult(),
                                     num_classes)
                           if num_classes > 0 else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits for an NCHW batch (channels_last memory).  ``generator``
        drives drop_path and dropout in train mode."""
        if x.shape[1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        x = self.act_fn(self.bn1(self.conv_stem(x)))
        for stage in self.blocks:
            for block in stage:
                x = block(x, generator)
        x = self.act_fn(self.bn2(self.conv_head(x)))
        feat = self.global_pool(x)
        if self.training and self.drop_rate > 0.0:
            feat = dropout(feat, self.drop_rate, generator)
        if self.classifier is None:
            return feat
        return self.classifier(feat)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in module order: goog conv init, unit BN, goog dense
    head with zero bias."""
    for m in model.modules():
        if isinstance(m, (Conv2d, BatchNorm2d)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            dense_init_goog(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _make(arch_def, channel_multiplier=1.0, depth_multiplier=1.0,
          depth_trunc="ceil", experts_multiplier=1, fix_first_last=False,
          stem_size=32, num_features=None, num_features_base=1280,
          act="relu", output_stride=32, **kwargs) -> EfficientNet:
    """Shared generator plumbing: decode DSL, scale, round, build module."""
    variant = kwargs.pop("variant", None)
    bn_args = resolve_bn_args(kwargs)
    drop_path_rate = kwargs.pop("drop_path_rate", 0.0)
    dcr = kwargs.pop("drop_connect_rate", None)
    if dcr is not None:
        drop_path_rate = dcr
    kwargs.pop("pretrained", None)
    decoded = decode_arch_def(arch_def, depth_multiplier, depth_trunc,
                              experts_multiplier, fix_first_last)
    block_configs = build_block_configs(
        decoded, channel_multiplier=channel_multiplier,
        output_stride=output_stride, drop_path_rate=drop_path_rate,
        default_act=act)
    if num_features is None:
        num_features = round_channels(num_features_base, channel_multiplier)
    stem_size = round_channels(stem_size, channel_multiplier)
    cfg = default_cfgs.get(variant, _cfg()) if variant else _cfg()
    known = dict(num_classes=kwargs.pop("num_classes", cfg.get("num_classes", 1000)),
                 in_chans=kwargs.pop("in_chans", 3),
                 drop_rate=kwargs.pop("drop_rate", 0.0),
                 global_pool=kwargs.pop("global_pool", "avg"),
                 norm_layer=kwargs.pop("norm_layer", "bn"),
                 pad_type=kwargs.pop("pad_type", ""),
                 se_kwargs=kwargs.pop("se_kwargs", None))
    kwargs.pop("strict", None)
    if kwargs:
        raise TypeError(f"unexpected model kwargs: {sorted(kwargs)}")
    return EfficientNet(block_configs=block_configs, num_features=num_features,
                        stem_size=stem_size, act=act, default_cfg=cfg,
                        bn_momentum=bn_args.get("momentum", 0.1),
                        bn_eps=bn_args.get("eps", 1e-5), **known)


_EFFICIENTNET_ARCH = [
    ["ds_r1_k3_s1_e1_c16_se0.25"],
    ["ir_r2_k3_s2_e6_c24_se0.25"],
    ["ir_r2_k5_s2_e6_c40_se0.25"],
    ["ir_r3_k3_s2_e6_c80_se0.25"],
    ["ir_r3_k5_s1_e6_c112_se0.25"],
    ["ir_r4_k5_s2_e6_c192_se0.25"],
    ["ir_r1_k3_s1_e6_c320_se0.25"],
]


def _gen_efficientnet(variant, channel_multiplier=1.0, depth_multiplier=1.0,
                      **kwargs):
    """Standard compound-scaled EfficientNet."""
    return _make(_EFFICIENTNET_ARCH, channel_multiplier, depth_multiplier,
                 stem_size=32, act=kwargs.pop("act", "swish"),
                 variant=variant, **kwargs)


def _gen_efficientnet_deepfake(variant, channel_multiplier=2.0,
                               depth_multiplier=3.1, **kwargs):
    """Deepfake config: B7 width/depth scaling, stem
    ``round_channels(128, 2.0) = 256`` and ``num_features = 256``, Swish,
    BatchNorm."""
    return _make(_EFFICIENTNET_ARCH, channel_multiplier, depth_multiplier,
                 stem_size=128, num_features_base=128,
                 act=kwargs.pop("act", "swish"), variant=variant, **kwargs)


# ---------------------------------------------------------------------------
# Registered entrypoints
# ---------------------------------------------------------------------------

_B_SCALING = {  # (channel_multiplier, depth_multiplier)
    0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4),
    4: (1.4, 1.8), 5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1), 8: (2.2, 3.6),
}


def _register_scaled(name, gen, cm, dm=1.0, doc=""):
    def fn(pretrained=False, *, _name=name, _cm=cm, _dm=dm, _gen=gen,
           **kwargs):
        return _gen(_name, _cm, _dm, **kwargs)
    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    fn.__doc__ = doc or f"{name} (w={cm}, d={dm})."
    register_model(fn)


for _i, (_cm, _dm) in _B_SCALING.items():
    _register_scaled(f"efficientnet_b{_i}", _gen_efficientnet, _cm, _dm,
                     doc=f"EfficientNet-B{_i} (w={_cm}, d={_dm}).")


@register_model
def efficientnet_b7_deepfake(pretrained=False, **kwargs):
    """B7 scaling, 2 classes."""
    kwargs.setdefault("num_classes", 2)
    return _gen_efficientnet("efficientnet_b7_deepfake", 2.0, 3.1, **kwargs)


@register_model
def efficientnet_deepfake_v3(pretrained=False, **kwargs):
    """Deepfake config, 12-channel input."""
    kwargs.setdefault("num_classes", 2)
    kwargs.setdefault("in_chans", 12)
    return _gen_efficientnet_deepfake("efficientnet_deepfake_v3", **kwargs)


@register_model
def efficientnet_deepfake_v4(pretrained=False, **kwargs):
    """The flagship config."""
    kwargs.setdefault("num_classes", 2)
    kwargs.setdefault("in_chans", 12)
    return _gen_efficientnet_deepfake("efficientnet_deepfake_v4", **kwargs)
