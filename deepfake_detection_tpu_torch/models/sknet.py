"""Selective-Kernel networks SKResNet / SKResNeXt (PyTorch).

Counterpart of ``deepfake_detection_tpu/models/sknet.py``: the
``SelectiveKernelBasic`` and ``SelectiveKernelBottleneck`` blocks plugged
into the generic :class:`~.resnet.ResNet`, and the 5 names; the SK conv is
``ops/attention.py``'s.  timm's names: the plain convs outside the SK conv
are ``ConvBnAct``s, ``conv{i}.conv``/``conv{i}.bn``.  As in the JAX
blocks, DropBlock is not applied, and ``zero_init_last_bn`` defaults to
False for every SK net.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import ConvBn, SelectiveKernelConv
from ..ops.conv import Conv2d
from ..ops.norm import BatchNorm2d
from ..registry import register_model
from .resnet import ResNet, _Block, _cfg, register_block

__all__ = ["SelectiveKernelBasic", "SelectiveKernelBottleneck"]


class SelectiveKernelBasic(_Block):
    """SK conv 3×3 → plain 3×3, expansion 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, sk_kwargs=None, **kw):
        super().__init__(inplanes, planes, **kw)
        if self.cardinality != 1 or self.base_width != 64:
            raise ValueError("SelectiveKernelBasic takes cardinality 1, "
                             "base width 64")
        first = planes // self.reduce_first
        self.conv1 = SelectiveKernelConv(
            inplanes, first, stride=self.stride, dilation=self.first_dilation,
            act=self.act, **(sk_kwargs or {}))
        self.conv2 = ConvBn(Conv2d(first, self.outplanes, 3,
                                   dilation=self.dilation),
                            BatchNorm2d(self.outplanes, **self.bn_args))
        self._tail(0, self.conv2.bn)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._finish(self.conv2(self.conv1(x)), x, generator)


class SelectiveKernelBottleneck(_Block):
    """1×1 → SK conv → 1×1, expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, sk_kwargs=None, **kw):
        super().__init__(inplanes, planes, **kw)
        width = int(math.floor(planes * (self.base_width / 64))
                    * self.cardinality)
        first = width // self.reduce_first
        self.conv1 = ConvBn(Conv2d(inplanes, first, 1),
                            BatchNorm2d(first, **self.bn_args))
        self.conv2 = SelectiveKernelConv(
            first, width, stride=self.stride, dilation=self.first_dilation,
            groups=self.cardinality, act=self.act,
            **(sk_kwargs or {}))
        self.conv3 = ConvBn(Conv2d(width, self.outplanes, 1),
                            BatchNorm2d(self.outplanes, **self.bn_args))
        self._tail(0, self.conv3.bn)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.conv2(self.act_fn(self.conv1(x)))
        return self._finish(self.conv3(y), x, generator)


register_block("sk_basic", SelectiveKernelBasic)
register_block("sk_bottleneck", SelectiveKernelBottleneck)

# the 18/34 variants split the input channels across the paths
_SK_SMALL = dict(min_attn_channels=16, attn_reduction=8, split_input=True)

# name: (block, layers, extra ResNet kwargs, sk_kwargs)
_SKNET_DEFS = {
    "skresnet18": ("sk_basic", (2, 2, 2, 2), {}, _SK_SMALL),
    "skresnet34": ("sk_basic", (3, 4, 6, 3), {}, _SK_SMALL),
    "skresnet50": ("sk_bottleneck", (3, 4, 6, 3), {},
                   dict(split_input=True)),
    "skresnet50d": ("sk_bottleneck", (3, 4, 6, 3),
                    dict(stem_width=32, stem_type="deep", avg_down=True),
                    dict(split_input=True)),
    "skresnext50_32x4d": ("sk_bottleneck", (3, 4, 6, 3),
                          dict(cardinality=32, base_width=4), None),
}


def _register():
    for name, (block, layers, extra, skk) in _SKNET_DEFS.items():
        def fn(pretrained=False, *, _block=block, _layers=layers,
               _extra=extra, _skk=skk, **kwargs):
            kwargs.pop("pretrained", None)
            ba = kwargs.pop("block_args", {})
            if _skk is not None:
                ba = {"sk_kwargs": dict(_skk), **ba}
            kwargs.setdefault("default_cfg", _cfg())
            kwargs.setdefault("zero_init_last_bn", False)
            return ResNet(block=_block, layers=tuple(_layers), block_args=ba,
                          **{**_extra, **kwargs})
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name}."
        register_model(fn)


_register()
