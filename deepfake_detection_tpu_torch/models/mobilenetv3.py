"""MobileNetV3 family (PyTorch), built on the EfficientNet generator.

Counterpart of ``deepfake_detection_tpu/models/mobilenetv3.py`` (11
entrypoints): large/small × width, the ``minimal`` ReLU-only variants, the
``rw`` variant (``head_bias=False``), and the ``tf_`` weight-compat configs
(TF ``'same'`` padding, TF BN defaults).  The MobileNetV3 head (pool → 1×1
``conv_head`` → act → classifier, no ``bn2``) and the paper's SE (ReLU
squeeze act, hard-sigmoid gate, reduction computed from the *expanded*
channels with divisor 8) ride the shared ``EfficientNet`` module via
``head_type='mobilenetv3'`` / ``se_kwargs``.  Every dw stage is a single
k3 or k5 kernel, so every one goes through the fused depthwise op.
"""

from __future__ import annotations

from ..registry import register_model
from .efficientnet import (IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD,
                           _cfg, _make, default_cfgs)

_LARGE_ARCH = [
    ["ds_r1_k3_s1_e1_c16_nre"],
    ["ir_r1_k3_s2_e4_c24_nre", "ir_r1_k3_s1_e3_c24_nre"],
    ["ir_r3_k5_s2_e3_c40_se0.25_nre"],
    ["ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"],
    ["ir_r2_k3_s1_e6_c112_se0.25"],
    ["ir_r3_k5_s2_e6_c160_se0.25"],
    ["cn_r1_k1_s1_c960"],
]

_LARGE_MINIMAL_ARCH = [
    ["ds_r1_k3_s1_e1_c16"],
    ["ir_r1_k3_s2_e4_c24", "ir_r1_k3_s1_e3_c24"],
    ["ir_r3_k3_s2_e3_c40"],
    ["ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"],
    ["ir_r2_k3_s1_e6_c112"],
    ["ir_r3_k3_s2_e6_c160"],
    ["cn_r1_k1_s1_c960"],
]

_SMALL_ARCH = [
    ["ds_r1_k3_s2_e1_c16_se0.25_nre"],
    ["ir_r1_k3_s2_e4.5_c24_nre", "ir_r1_k3_s1_e3.67_c24_nre"],
    ["ir_r1_k5_s2_e4_c40_se0.25", "ir_r2_k5_s1_e6_c40_se0.25"],
    ["ir_r2_k5_s1_e3_c48_se0.25"],
    ["ir_r3_k5_s2_e6_c96_se0.25"],
    ["cn_r1_k1_s1_c576"],
]

_SMALL_MINIMAL_ARCH = [
    ["ds_r1_k3_s2_e1_c16"],
    ["ir_r1_k3_s2_e4.5_c24", "ir_r1_k3_s1_e3.67_c24"],
    ["ir_r1_k3_s2_e4_c40", "ir_r2_k3_s1_e6_c40"],
    ["ir_r2_k3_s1_e3_c48"],
    ["ir_r3_k3_s2_e6_c96"],
    ["cn_r1_k1_s1_c576"],
]

_RW_ARCH = [
    ["ds_r1_k3_s1_e1_c16_nre_noskip"],
    ["ir_r1_k3_s2_e4_c24_nre", "ir_r1_k3_s1_e3_c24_nre"],
    ["ir_r3_k5_s2_e3_c40_se0.25_nre"],
    ["ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"],
    ["ir_r2_k3_s1_e6_c112_se0.25"],
    ["ir_r3_k5_s2_e6_c160_se0.25"],
    ["cn_r1_k1_s1_c960"],
]

for _name in ("mobilenetv3_large_075", "mobilenetv3_large_100",
              "mobilenetv3_small_075", "mobilenetv3_small_100",
              "mobilenetv3_rw"):
    default_cfgs.setdefault(_name, _cfg(interpolation="bilinear"))
for _name in ("tf_mobilenetv3_large_075", "tf_mobilenetv3_large_100",
              "tf_mobilenetv3_large_minimal_100", "tf_mobilenetv3_small_075",
              "tf_mobilenetv3_small_100", "tf_mobilenetv3_small_minimal_100"):
    default_cfgs.setdefault(_name, _cfg(
        interpolation="bilinear", mean=IMAGENET_INCEPTION_MEAN,
        std=IMAGENET_INCEPTION_STD))


def _gen_mobilenet_v3(variant, channel_multiplier=1.0, **kwargs):
    """Large or small, minimal or not, by the variant's name."""
    small = "small" in variant
    minimal = "minimal" in variant
    num_features = 1024 if small else 1280
    if minimal:
        act = "relu"
        arch = _SMALL_MINIMAL_ARCH if small else _LARGE_MINIMAL_ARCH
    else:
        act = "hard_swish"
        arch = _SMALL_ARCH if small else _LARGE_ARCH
    se_kwargs = dict(act="relu", gate_fn="hard_sigmoid", reduce_mid=True,
                     divisor=8)
    return _make(arch, channel_multiplier, stem_size=16,
                 num_features=num_features, act=act, head_type="mobilenetv3",
                 se_kwargs=se_kwargs, variant=variant, **kwargs)


def _gen_mobilenet_v3_rw(variant, channel_multiplier=1.0, **kwargs):
    """``head_bias=False``, SE divisor 1 and the squeeze act following the
    block act."""
    se_kwargs = dict(gate_fn="hard_sigmoid", reduce_mid=True, divisor=1)
    return _make(_RW_ARCH, channel_multiplier, stem_size=16,
                 num_features=1280, act="hard_swish",
                 head_type="mobilenetv3", head_bias=False,
                 se_kwargs=se_kwargs, variant=variant, **kwargs)


def _register():
    names = ["mobilenetv3_large_075", "mobilenetv3_large_100",
             "mobilenetv3_small_075", "mobilenetv3_small_100",
             "tf_mobilenetv3_large_075", "tf_mobilenetv3_large_100",
             "tf_mobilenetv3_large_minimal_100", "tf_mobilenetv3_small_075",
             "tf_mobilenetv3_small_100", "tf_mobilenetv3_small_minimal_100"]
    for name in names:
        mult = 0.75 if "_075" in name else 1.0

        def fn(pretrained=False, *, _name=name, _mult=mult, **kwargs):
            if _name.startswith("tf_"):
                kwargs.setdefault("bn_tf", True)
                kwargs.setdefault("pad_type", "same")   # TF SAME padding
            return _gen_mobilenet_v3(_name, _mult, **kwargs)
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name} (w={mult})."
        register_model(fn)


_register()


@register_model
def mobilenetv3_rw(pretrained=False, **kwargs):
    return _gen_mobilenet_v3_rw("mobilenetv3_rw", 1.0, **kwargs)
