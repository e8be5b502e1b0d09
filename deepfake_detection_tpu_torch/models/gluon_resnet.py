"""Gluon ResNet / ResNeXt / SE-ResNeXt / SENet variants (PyTorch).

Counterpart of ``deepfake_detection_tpu/models/gluon_resnet.py``: its 24
names, each a parameterization of the generic :class:`~.resnet.ResNet`
(v1b plain, v1c deep stem 32, v1d deep stem 32 + avg-down, v1e deep stem
64 + avg-down, v1s deep stem 64; ``gluon_senet154`` a deep stem, 3×3
shortcut convs and the first bottleneck conv at half width), with the
bicubic ``default_cfg``.
"""

from __future__ import annotations

from ..registry import register_model
from .resnet import ResNet, _cfg

__all__ = []

_V1C = dict(stem_width=32, stem_type="deep")
_V1D = dict(stem_width=32, stem_type="deep", avg_down=True)
_V1E = dict(stem_width=64, stem_type="deep", avg_down=True)
_V1S = dict(stem_width=64, stem_type="deep")

# name: (block, layers, extra kwargs)
_GLUON_DEFS = {
    "gluon_resnet18_v1b": ("basic", (2, 2, 2, 2), {}),
    "gluon_resnet34_v1b": ("basic", (3, 4, 6, 3), {}),
    "gluon_resnet50_v1b": ("bottleneck", (3, 4, 6, 3), {}),
    "gluon_resnet101_v1b": ("bottleneck", (3, 4, 23, 3), {}),
    "gluon_resnet152_v1b": ("bottleneck", (3, 8, 36, 3), {}),
    "gluon_resnet50_v1c": ("bottleneck", (3, 4, 6, 3), _V1C),
    "gluon_resnet101_v1c": ("bottleneck", (3, 4, 23, 3), _V1C),
    "gluon_resnet152_v1c": ("bottleneck", (3, 8, 36, 3), _V1C),
    "gluon_resnet50_v1d": ("bottleneck", (3, 4, 6, 3), _V1D),
    "gluon_resnet101_v1d": ("bottleneck", (3, 4, 23, 3), _V1D),
    "gluon_resnet152_v1d": ("bottleneck", (3, 8, 36, 3), _V1D),
    "gluon_resnet50_v1e": ("bottleneck", (3, 4, 6, 3), _V1E),
    "gluon_resnet101_v1e": ("bottleneck", (3, 4, 23, 3), _V1E),
    "gluon_resnet152_v1e": ("bottleneck", (3, 8, 36, 3), _V1E),
    "gluon_resnet50_v1s": ("bottleneck", (3, 4, 6, 3), _V1S),
    "gluon_resnet101_v1s": ("bottleneck", (3, 4, 23, 3), _V1S),
    "gluon_resnet152_v1s": ("bottleneck", (3, 8, 36, 3), _V1S),
    "gluon_resnext50_32x4d": ("bottleneck", (3, 4, 6, 3),
                              dict(cardinality=32, base_width=4)),
    "gluon_resnext101_32x4d": ("bottleneck", (3, 4, 23, 3),
                               dict(cardinality=32, base_width=4)),
    "gluon_resnext101_64x4d": ("bottleneck", (3, 4, 23, 3),
                               dict(cardinality=64, base_width=4)),
    "gluon_seresnext50_32x4d": ("bottleneck", (3, 4, 6, 3),
                                dict(cardinality=32, base_width=4,
                                     attn_layer="se")),
    "gluon_seresnext101_32x4d": ("bottleneck", (3, 4, 23, 3),
                                 dict(cardinality=32, base_width=4,
                                      attn_layer="se")),
    "gluon_seresnext101_64x4d": ("bottleneck", (3, 4, 23, 3),
                                 dict(cardinality=64, base_width=4,
                                      attn_layer="se")),
    "gluon_senet154": ("bottleneck", (3, 8, 36, 3),
                       dict(cardinality=64, base_width=4, stem_type="deep",
                            down_kernel_size=3, block_reduce_first=2,
                            attn_layer="se")),
}


def _gluon_cfg():
    return _cfg(interpolation="bicubic")


def _register():
    for name, (block, layers, extra) in _GLUON_DEFS.items():
        def fn(pretrained=False, *, _block=block, _layers=layers,
               _extra=extra, **kwargs):
            kwargs.pop("pretrained", None)
            kwargs.setdefault("default_cfg", _gluon_cfg())
            return ResNet(block=_block, layers=tuple(_layers),
                          **{**_extra, **kwargs})
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name}."
        register_model(fn)


_register()
