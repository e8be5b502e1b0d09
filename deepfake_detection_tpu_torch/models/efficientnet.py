"""EfficientNet family (PyTorch, NCHW in channels_last memory).

Counterpart of ``deepfake_detection_tpu/models/efficientnet.py``: the
generic EfficientNet and every generator the JAX module registers — the
compound-scaled B0–B8 and L2 with their ``tf_*`` (TF ``'same'`` padding,
TF BN defaults), AdvProp ``_ap`` and Noisy-Student ``_ns`` variants,
EdgeTPU (``efficientnet_es/em/el``), CondConv (``efficientnet_cc_*``),
MixNet, MnasNet, FBNet-C, Single-Path NAS, MobileNet-V2, and the deepfake
configs ``efficientnet_b7_deepfake``, ``efficientnet_deepfake_v3`` and the
flagship ``efficientnet_deepfake_v4`` (12 input channels = 4 RGB frames,
600², B7 width/depth scaling with stem 256 and head 256, Swish, SE).
:mod:`.mobilenetv3` builds on the same module with its head
(``head_type="mobilenetv3"``).  Module and parameter names are timm's:
``conv_stem``, ``bn1``, ``blocks.{stage}.{block}.*``, ``conv_head``,
``bn2``, ``classifier``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops.activations import get_act_fn
from ..ops.conv import CondConv2d, Conv2d, dense_init_goog
from ..ops.drop import dropout
from ..ops.linear import Linear
from ..ops.norm import BatchNorm2d, resolve_bn_args
from ..ops.pool import SelectAdaptivePool2d
from ..registry import register_model
from .efficientnet_blocks import (CondConvResidual, ConvBnAct,
                                  DepthwiseSeparableConv, EdgeResidual,
                                  InvertedResidual, _norm, is_mixed,
                                  round_channels)
from .efficientnet_builder import build_block_configs, decode_arch_def

__all__ = ["EfficientNet", "init_weights", "fused_dw_stages"]

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


def _cfg(url: str = "", **kwargs) -> Dict[str, Any]:
    cfg = dict(url=url, num_classes=1000, input_size=(3, 224, 224),
               pool_size=(7, 7), crop_pct=0.875, interpolation="bicubic",
               mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
               first_conv="conv_stem", classifier="classifier")
    cfg.update(kwargs)
    return cfg


# the JAX module's table; a registered name without an entry takes _cfg()
default_cfgs: Dict[str, Dict[str, Any]] = {
    **{f"efficientnet_b{i}": _cfg(input_size=(3, r, r))
       for i, r in enumerate([224, 240, 260, 300, 380, 456, 528, 600, 672])},
    "efficientnet_l2": _cfg(input_size=(3, 800, 800), crop_pct=0.961),
    "efficientnet_b7_deepfake": _cfg(input_size=(3, 450, 800), num_classes=2),
    "efficientnet_deepfake_v3": _cfg(input_size=(12, 600, 600), num_classes=2),
    "efficientnet_deepfake_v4": _cfg(input_size=(12, 600, 600), num_classes=2),
    **{f"tf_efficientnet_b{i}": _cfg(input_size=(3, r, r))
       for i, r in enumerate([224, 240, 260, 300, 380, 456, 528, 600, 672])},
    "efficientnet_es": _cfg(), "efficientnet_em": _cfg(input_size=(3, 240, 240)),
    "efficientnet_el": _cfg(input_size=(3, 300, 300)),
    "efficientnet_cc_b0_4e": _cfg(), "efficientnet_cc_b0_8e": _cfg(),
    "efficientnet_cc_b1_8e": _cfg(input_size=(3, 240, 240)),
    "mixnet_s": _cfg(), "mixnet_m": _cfg(), "mixnet_l": _cfg(),
    "mixnet_xl": _cfg(),
    "mnasnet_050": _cfg(), "mnasnet_075": _cfg(), "mnasnet_100": _cfg(),
    "mnasnet_140": _cfg(), "mnasnet_small": _cfg(),
    "semnasnet_050": _cfg(), "semnasnet_075": _cfg(), "semnasnet_100": _cfg(),
    "semnasnet_140": _cfg(), "mnasnet_a1": _cfg(), "mnasnet_b1": _cfg(),
    "fbnetc_100": _cfg(), "spnasnet_100": _cfg(),
}

_BLOCK_TYPES = {
    "ir": InvertedResidual,
    "ds": DepthwiseSeparableConv,
    "er": EdgeResidual,
    "cn": ConvBnAct,
    "cc": CondConvResidual,
}


class EfficientNet(nn.Module):
    """Generic EfficientNet: stem conv → blocks → head → classifier.
    ``block_configs`` comes from :func:`build_block_configs`.  The head is
    ``head_type="efficientnet"``'s 1×1 ``conv_head`` → ``bn2`` → act →
    global pool, or ``"mobilenetv3"``'s global pool → 1×1 ``conv_head``
    (with a bias when ``head_bias``) → act, which has no ``bn2``."""

    def __init__(self, block_configs, num_classes: int = 1000,
                 num_features: int = 1280, in_chans: int = 3,
                 stem_size: int = 32, act: Any = "relu",
                 drop_rate: float = 0.0, global_pool: str = "avg",
                 head_type: str = "efficientnet", head_bias: bool = True,
                 se_kwargs: Any = None, norm_layer: str = "bn",
                 pad_type: str = "", bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5, default_cfg: Optional[dict] = None):
        super().__init__()
        self.in_chans = in_chans
        self.drop_rate = drop_rate
        self.head_type = head_type
        self.block_configs = block_configs
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
                block = _BLOCK_TYPES[btype](chs, **cfg, **bnk, act=block_act)
                chs = block.out_chs
                blocks.append(block)
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        if head_type == "mobilenetv3":
            self.global_pool = SelectAdaptivePool2d(global_pool,
                                                    flatten=False)
            self.conv_head = Conv2d(chs * self.global_pool.feat_mult(),
                                    num_features, 1, bias=head_bias)
            feat_chs = num_features
        else:
            self.conv_head = Conv2d(chs, num_features, 1)
            self.bn2 = _norm(norm_layer, num_features, bn_momentum, bn_eps)
            self.global_pool = SelectAdaptivePool2d(global_pool)
            feat_chs = num_features * self.global_pool.feat_mult()
        self.classifier = (Linear(feat_chs, num_classes)
                           if num_classes > 0 else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False, pool: bool = True):
        """Logits for an NCHW batch (channels_last memory).  ``generator``
        drives drop_path and dropout in train mode.  ``features_only``
        returns each stage's output instead; ``pool=False`` the
        efficientnet head's map before the pool (the mobilenetv3 head pools
        first, and ignores it), as the JAX module's arguments."""
        if x.shape[1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        x = self.act_fn(self.bn1(self.conv_stem(x)))
        stage_feats = []
        for stage in self.blocks:
            for block in stage:
                x = block(x, generator)
            stage_feats.append(x)
        if features_only:
            return stage_feats
        if self.head_type == "mobilenetv3":
            feat = self.act_fn(self.conv_head(self.global_pool(x)))[:, :, 0, 0]
        else:
            x = self.act_fn(self.bn2(self.conv_head(x)))
            if not pool:
                return x
            feat = self.global_pool(x)
        if self.training and self.drop_rate > 0.0:
            feat = dropout(feat, self.drop_rate, generator)
        if self.classifier is None:
            return feat
        return self.classifier(feat)


def fused_dw_stages(block_configs) -> int:
    """The single-kernel depthwise stages of an arch's block configs (an
    ``EfficientNet``'s ``block_configs``): the stages the fused depthwise
    op runs, once each a forward."""
    return sum(cfg["block_type"] in ("ir", "ds")
               and not is_mixed(cfg["dw_kernel_size"])
               for stage in block_configs for cfg in stage)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in module order: goog conv init (each CondConv expert
    on its own), unit BN, goog dense head with zero bias; a CondConv
    router U(±1/sqrt(in + out)), timm's rule for ``routing_fn``."""
    for name, m in model.named_modules():
        if isinstance(m, (Conv2d, CondConv2d, BatchNorm2d)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            if name.endswith("routing_fn"):
                r = 1.0 / math.sqrt(m.in_features + m.out_features)
                with torch.no_grad():
                    m.weight.uniform_(-r, r, generator=generator)
            else:
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
                 head_type=kwargs.pop("head_type", "efficientnet"),
                 head_bias=kwargs.pop("head_bias", True),
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


_EDGE_ARCH = [
    ["er_r1_k3_s1_e4_c24_fc24_noskip"],
    ["er_r2_k3_s2_e8_c32"],
    ["er_r4_k3_s2_e8_c48"],
    ["ir_r5_k5_s2_e8_c96"],
    ["ir_r4_k5_s1_e8_c144"],
    ["ir_r2_k5_s2_e8_c192"],
]


def _gen_efficientnet_edge(variant, channel_multiplier=1.0,
                           depth_multiplier=1.0, **kwargs):
    return _make(_EDGE_ARCH, channel_multiplier, depth_multiplier,
                 stem_size=32, act="relu", variant=variant, **kwargs)


_CONDCONV_ARCH = [
    ["ds_r1_k3_s1_e1_c16_se0.25"],
    ["ir_r2_k3_s2_e6_c24_se0.25"],
    ["ir_r2_k5_s2_e6_c40_se0.25"],
    ["ir_r3_k3_s2_e6_c80_se0.25"],
    ["ir_r3_k5_s1_e6_c112_se0.25_cc4"],
    ["ir_r4_k5_s2_e6_c192_se0.25_cc4"],
    ["ir_r1_k3_s1_e6_c320_se0.25_cc4"],
]


def _gen_efficientnet_condconv(variant, channel_multiplier=1.0,
                               depth_multiplier=1.0, experts_multiplier=1,
                               **kwargs):
    return _make(_CONDCONV_ARCH, channel_multiplier, depth_multiplier,
                 experts_multiplier=experts_multiplier, stem_size=32,
                 act="swish", variant=variant, **kwargs)


def _gen_mnasnet_b1(variant, channel_multiplier=1.0, **kwargs):
    arch = [
        ["ds_r1_k3_s1_c16_noskip"],
        ["ir_r3_k3_s2_e3_c24"],
        ["ir_r3_k5_s2_e3_c40"],
        ["ir_r3_k5_s2_e6_c80"],
        ["ir_r2_k3_s1_e6_c96"],
        ["ir_r4_k5_s2_e6_c192"],
        ["ir_r1_k3_s1_e6_c320_noskip"],
    ]
    return _make(arch, channel_multiplier, depth_trunc="round", stem_size=32,
                 num_features=1280, act="relu", variant=variant, **kwargs)


def _gen_mnasnet_a1(variant, channel_multiplier=1.0, **kwargs):
    arch = [
        ["ds_r1_k3_s1_c16_noskip"],
        ["ir_r2_k3_s2_e6_c24"],
        ["ir_r3_k5_s2_e3_c40_se0.25"],
        ["ir_r4_k3_s2_e6_c80"],
        ["ir_r2_k3_s1_e6_c112_se0.25"],
        ["ir_r3_k5_s2_e6_c160_se0.25"],
        ["ir_r1_k3_s1_e6_c320"],
    ]
    return _make(arch, channel_multiplier, depth_trunc="round", stem_size=32,
                 num_features=1280, act="relu", variant=variant, **kwargs)


def _gen_mnasnet_small(variant, channel_multiplier=1.0, **kwargs):
    arch = [
        ["ds_r1_k3_s1_c8"],
        ["ir_r1_k3_s2_e3_c16"],
        ["ir_r2_k3_s2_e6_c16"],
        ["ir_r4_k5_s2_e6_c32_se0.25"],
        ["ir_r3_k3_s1_e6_c32_se0.25"],
        ["ir_r3_k5_s2_e6_c88_se0.25"],
        ["ir_r1_k3_s1_e6_c144"],
    ]
    return _make(arch, channel_multiplier, depth_trunc="round", stem_size=8,
                 num_features=1280, act="relu", variant=variant, **kwargs)


_MOBILENETV2_ARCH = [
    ["ds_r1_k3_s1_c16"],
    ["ir_r2_k3_s2_e6_c24"],
    ["ir_r3_k3_s2_e6_c32"],
    ["ir_r4_k3_s2_e6_c64"],
    ["ir_r3_k3_s1_e6_c96"],
    ["ir_r3_k3_s2_e6_c160"],
    ["ir_r1_k3_s1_e6_c320"],
]


def _gen_mobilenet_v2(variant, channel_multiplier=1.0, depth_multiplier=1.0,
                      **kwargs):
    """MobileNet-V2: ReLU6, stem 32."""
    return _make(_MOBILENETV2_ARCH, channel_multiplier, depth_multiplier,
                 stem_size=32, num_features=1280, act="relu6",
                 variant=variant, **kwargs)


def _gen_fbnetc(variant, channel_multiplier=1.0, **kwargs):
    arch = [
        ["ir_r1_k3_s1_e1_c16"],
        ["ir_r1_k3_s2_e6_c24", "ir_r2_k3_s1_e1_c24"],
        ["ir_r1_k5_s2_e6_c32", "ir_r1_k5_s1_e3_c32", "ir_r1_k3_s1_e6_c32",
         "ir_r1_k5_s1_e6_c32"],
        ["ir_r1_k5_s2_e6_c64", "ir_r1_k5_s1_e3_c64", "ir_r2_k5_s1_e6_c64"],
        ["ir_r3_k5_s1_e6_c112", "ir_r1_k5_s1_e3_c112"],
        ["ir_r4_k5_s2_e6_c184"],
        ["ir_r1_k3_s1_e6_c352"],
    ]
    return _make(arch, channel_multiplier, depth_trunc="round", stem_size=16,
                 num_features=1984, act="relu", variant=variant, **kwargs)


def _gen_spnasnet(variant, channel_multiplier=1.0, **kwargs):
    arch = [
        ["ds_r1_k3_s1_c16_noskip"],
        ["ir_r3_k3_s2_e3_c24"],
        ["ir_r1_k5_s2_e6_c40", "ir_r3_k3_s1_e3_c40"],
        ["ir_r1_k5_s2_e6_c80", "ir_r3_k3_s1_e3_c80"],
        ["ir_r1_k5_s1_e6_c96", "ir_r3_k5_s1_e3_c96"],
        ["ir_r4_k5_s2_e6_c192"],
        ["ir_r1_k3_s1_e6_c320_noskip"],
    ]
    return _make(arch, channel_multiplier, depth_trunc="round", stem_size=32,
                 num_features=1280, act="relu", variant=variant, **kwargs)


_MIXNET_S_ARCH = [
    ["ds_r1_k3_s1_e1_c16"],
    ["ir_r1_k3_a1.1_p1.1_s2_e6_c24", "ir_r1_k3_a1.1_p1.1_s1_e3_c24"],
    ["ir_r1_k3.5.7_s2_e6_c40_se0.5_nsw",
     "ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw"],
    ["ir_r1_k3.5.7_p1.1_s2_e6_c80_se0.25_nsw",
     "ir_r2_k3.5_p1.1_s1_e6_c80_se0.25_nsw"],
    ["ir_r1_k3.5.7_a1.1_p1.1_s1_e6_c120_se0.5_nsw",
     "ir_r2_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw"],
    ["ir_r1_k3.5.7.9.11_s2_e6_c200_se0.5_nsw",
     "ir_r2_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw"],
]

_MIXNET_M_ARCH = [
    ["ds_r1_k3_s1_e1_c24"],
    ["ir_r1_k3.5.7_a1.1_p1.1_s2_e6_c32", "ir_r1_k3_a1.1_p1.1_s1_e3_c32"],
    ["ir_r1_k3.5.7.9_s2_e6_c40_se0.5_nsw",
     "ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw"],
    ["ir_r1_k3.5.7_s2_e6_c80_se0.25_nsw",
     "ir_r3_k3.5.7.9_a1.1_p1.1_s1_e6_c80_se0.25_nsw"],
    ["ir_r1_k3_s1_e6_c120_se0.5_nsw",
     "ir_r3_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw"],
    ["ir_r1_k3.5.7.9_s2_e6_c200_se0.5_nsw",
     "ir_r3_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw"],
]


def _gen_mixnet_s(variant, channel_multiplier=1.0, depth_multiplier=1.0,
                  **kwargs):
    return _make(_MIXNET_S_ARCH, channel_multiplier, depth_multiplier,
                 stem_size=16, num_features=1536, act="relu",
                 variant=variant, **kwargs)


def _gen_mixnet_m(variant, channel_multiplier=1.0, depth_multiplier=1.0,
                  **kwargs):
    return _make(_MIXNET_M_ARCH, channel_multiplier, depth_multiplier,
                 depth_trunc="round", stem_size=24,
                 num_features=1536, act="relu", variant=variant, **kwargs)



# ---------------------------------------------------------------------------
# Registered entrypoints
# ---------------------------------------------------------------------------

_B_SCALING = {  # (channel_multiplier, depth_multiplier)
    0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4),
    4: (1.4, 1.8), 5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1), 8: (2.2, 3.6),
}


def _register_scaled(name, gen, cm, dm=1.0, tf=False, doc=""):
    def fn(pretrained=False, *, _name=name, _cm=cm, _dm=dm, _tf=tf,
           _gen=gen, **kwargs):
        if _tf:
            kwargs.setdefault("bn_tf", True)
            kwargs.setdefault("pad_type", "same")   # TF SAME
        return _gen(_name, _cm, _dm, **kwargs)
    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    fn.__doc__ = doc or f"{name} (w={cm}, d={dm})."
    register_model(fn)


def _register_b_series():
    for i, (cm, dm) in _B_SCALING.items():
        _register_scaled(f"efficientnet_b{i}", _gen_efficientnet, cm, dm,
                         doc=f"EfficientNet-B{i} (w={cm}, d={dm}).")
        _register_scaled(f"tf_efficientnet_b{i}", _gen_efficientnet, cm, dm,
                         tf=True, doc=f"TF EfficientNet-B{i}.")
        # AdvProp / Noisy-Student weight variants: the same
        # architectures, TF BN defaults
        if i <= 8:
            _register_scaled(f"tf_efficientnet_b{i}_ap", _gen_efficientnet,
                             cm, dm, tf=True,
                             doc=f"TF EfficientNet-B{i} AdvProp.")
        if i <= 7:
            _register_scaled(f"tf_efficientnet_b{i}_ns", _gen_efficientnet,
                             cm, dm, tf=True,
                             doc=f"TF EfficientNet-B{i} NoisyStudent.")


_register_b_series()

# crop-pct 'a' variants and TF L2 NoisyStudent
_register_scaled("efficientnet_b2a", _gen_efficientnet, 1.1, 1.2)
_register_scaled("efficientnet_b3a", _gen_efficientnet, 1.2, 1.4)
_register_scaled("tf_efficientnet_l2_ns", _gen_efficientnet, 4.3, 5.3,
                 tf=True, doc="TF EfficientNet-L2 NoisyStudent.")
_register_scaled("tf_efficientnet_l2_ns_475", _gen_efficientnet, 4.3, 5.3,
                 tf=True, doc="TF EfficientNet-L2 NoisyStudent at 475².")
# TF edge / condconv / mixnet weight variants
_register_scaled("tf_efficientnet_es", _gen_efficientnet_edge, 1.0, 1.0,
                 tf=True)
_register_scaled("tf_efficientnet_em", _gen_efficientnet_edge, 1.0, 1.1,
                 tf=True)
_register_scaled("tf_efficientnet_el", _gen_efficientnet_edge, 1.2, 1.4,
                 tf=True)
_register_scaled("tf_mixnet_s", _gen_mixnet_s, 1.0, tf=True)
_register_scaled("tf_mixnet_m", _gen_mixnet_m, 1.0, tf=True)
_register_scaled("tf_mixnet_l", _gen_mixnet_m, 1.3, tf=True)
_register_scaled("mixnet_xxl", _gen_mixnet_m, 2.4, 1.3)
_register_scaled("mobilenetv2_100", _gen_mobilenet_v2, 1.0)


def _gen_condconv_tf(variant, channel_multiplier=1.0, depth_multiplier=1.0,
                     **kwargs):
    experts = 2 if variant.endswith("8e") else 1
    return _gen_efficientnet_condconv(variant, channel_multiplier,
                                      depth_multiplier, experts, **kwargs)


_register_scaled("tf_efficientnet_cc_b0_4e", _gen_condconv_tf, 1.0, 1.0,
                 tf=True)
_register_scaled("tf_efficientnet_cc_b0_8e", _gen_condconv_tf, 1.0, 1.0,
                 tf=True)
_register_scaled("tf_efficientnet_cc_b1_8e", _gen_condconv_tf, 1.0, 1.1,
                 tf=True)


@register_model
def efficientnet_l2(pretrained=False, **kwargs):
    return _gen_efficientnet("efficientnet_l2", 4.3, 5.3, **kwargs)


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


@register_model
def efficientnet_es(pretrained=False, **kwargs):
    return _gen_efficientnet_edge("efficientnet_es", 1.0, 1.0, **kwargs)


@register_model
def efficientnet_em(pretrained=False, **kwargs):
    return _gen_efficientnet_edge("efficientnet_em", 1.0, 1.1, **kwargs)


@register_model
def efficientnet_el(pretrained=False, **kwargs):
    return _gen_efficientnet_edge("efficientnet_el", 1.2, 1.4, **kwargs)


@register_model
def efficientnet_cc_b0_4e(pretrained=False, **kwargs):
    return _gen_efficientnet_condconv("efficientnet_cc_b0_4e", 1.0, 1.0, 1,
                                      **kwargs)


@register_model
def efficientnet_cc_b0_8e(pretrained=False, **kwargs):
    return _gen_efficientnet_condconv("efficientnet_cc_b0_8e", 1.0, 1.0, 2,
                                      **kwargs)


@register_model
def efficientnet_cc_b1_8e(pretrained=False, **kwargs):
    return _gen_efficientnet_condconv("efficientnet_cc_b1_8e", 1.0, 1.1, 2,
                                      **kwargs)


@register_model
def mixnet_s(pretrained=False, **kwargs):
    return _gen_mixnet_s("mixnet_s", 1.0, **kwargs)


@register_model
def mixnet_m(pretrained=False, **kwargs):
    return _gen_mixnet_m("mixnet_m", 1.0, **kwargs)


@register_model
def mixnet_l(pretrained=False, **kwargs):
    return _gen_mixnet_m("mixnet_l", 1.3, **kwargs)


@register_model
def mixnet_xl(pretrained=False, **kwargs):
    return _gen_mixnet_m("mixnet_xl", 1.6, 1.2, **kwargs)


@register_model
def mnasnet_050(pretrained=False, **kwargs):
    return _gen_mnasnet_b1("mnasnet_050", 0.5, **kwargs)


@register_model
def mnasnet_075(pretrained=False, **kwargs):
    return _gen_mnasnet_b1("mnasnet_075", 0.75, **kwargs)


@register_model
def mnasnet_100(pretrained=False, **kwargs):
    return _gen_mnasnet_b1("mnasnet_100", 1.0, **kwargs)


@register_model
def mnasnet_b1(pretrained=False, **kwargs):
    return _gen_mnasnet_b1("mnasnet_b1", 1.0, **kwargs)


@register_model
def mnasnet_140(pretrained=False, **kwargs):
    return _gen_mnasnet_b1("mnasnet_140", 1.4, **kwargs)


@register_model
def semnasnet_050(pretrained=False, **kwargs):
    return _gen_mnasnet_a1("semnasnet_050", 0.5, **kwargs)


@register_model
def semnasnet_075(pretrained=False, **kwargs):
    return _gen_mnasnet_a1("semnasnet_075", 0.75, **kwargs)


@register_model
def semnasnet_100(pretrained=False, **kwargs):
    return _gen_mnasnet_a1("semnasnet_100", 1.0, **kwargs)


@register_model
def mnasnet_a1(pretrained=False, **kwargs):
    return _gen_mnasnet_a1("mnasnet_a1", 1.0, **kwargs)


@register_model
def semnasnet_140(pretrained=False, **kwargs):
    return _gen_mnasnet_a1("semnasnet_140", 1.4, **kwargs)


@register_model
def mnasnet_small(pretrained=False, **kwargs):
    return _gen_mnasnet_small("mnasnet_small", 1.0, **kwargs)


@register_model
def fbnetc_100(pretrained=False, **kwargs):
    return _gen_fbnetc("fbnetc_100", 1.0, **kwargs)


@register_model
def spnasnet_100(pretrained=False, **kwargs):
    return _gen_spnasnet("spnasnet_100", 1.0, **kwargs)
