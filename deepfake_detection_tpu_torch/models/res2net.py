"""Res2Net / Res2NeXt (PyTorch).

Counterpart of ``deepfake_detection_tpu/models/res2net.py``: the
``Bottle2neck`` block plugged into the generic :class:`~.resnet.ResNet`,
and its 7 names.  timm's names: ``conv1``/``bn1``, the hierarchical 3×3s
``convs.{i}``/``bns.{i}``, ``conv3``/``bn3``, ``se``, ``downsample``.
As in the JAX block, DropBlock is not applied.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.conv import Conv2d
from ..ops.norm import BatchNorm2d
from ..ops.pool import avg_pool2d_torch
from ..registry import register_model
from .resnet import ResNet, _Block, _cfg, register_block

__all__ = ["Bottle2neck"]


class Bottle2neck(_Block):
    """1×1 to ``width·scale``, then ``scale - 1`` 3×3s over the channel
    splits, each fed the previous one's output plus its own split (its
    split alone in the block that downsamples), the last split passed
    through (pooled by ``AvgPool2d(3, stride, padding=1)``, the pad
    counted, in the first block), then 1×1."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, scale: int = 4, **kw):
        kw.setdefault("base_width", 26)
        super().__init__(inplanes, planes, **kw)
        width = int(math.floor(planes * (self.base_width / 64.0))) \
            * self.cardinality
        self.scale = scale
        self.width = width
        self.is_first = self.stride > 1 or self.has_downsample
        self.conv1 = Conv2d(inplanes, width * scale, 1)
        self.bn1 = BatchNorm2d(width * scale, **self.bn_args)
        n = max(1, scale - 1)
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, self.stride, dilation=self.first_dilation,
                   groups=self.cardinality) for _ in range(n))
        self.bns = nn.ModuleList(BatchNorm2d(width, **self.bn_args)
                                 for _ in range(n))
        self.conv3 = Conv2d(width * scale, self.outplanes, 1)
        self.bn3 = BatchNorm2d(self.outplanes, **self.bn_args)
        self._tail(0, self.bn3)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.act_fn(self.bn1(self.conv1(x)))
        spx = torch.split(y, self.width, dim=1)
        spo = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[i] if i == 0 or self.is_first else sp + spx[i]
            sp = self.act_fn(bn(conv(sp)))
            spo.append(sp)
        if self.scale > 1:
            spo.append(avg_pool2d_torch(spx[-1], 3, self.stride, padding=1)
                       if self.is_first else spx[-1])
        y = torch.cat(spo, dim=1)
        y = self.bn3(self.conv3(y))
        return self._finish(y, x, generator)


register_block("bottle2neck", Bottle2neck)


# name: (layers, base_width, extra ResNet kwargs, block_args)
_RES2NET_DEFS = {
    "res2net50_26w_4s": ((3, 4, 6, 3), 26, {}, dict(scale=4)),
    "res2net101_26w_4s": ((3, 4, 23, 3), 26, {}, dict(scale=4)),
    "res2net50_26w_6s": ((3, 4, 6, 3), 26, {}, dict(scale=6)),
    "res2net50_26w_8s": ((3, 4, 6, 3), 26, {}, dict(scale=8)),
    "res2net50_48w_2s": ((3, 4, 6, 3), 48, {}, dict(scale=2)),
    "res2net50_14w_8s": ((3, 4, 6, 3), 14, {}, dict(scale=8)),
    "res2next50": ((3, 4, 6, 3), 4, dict(cardinality=8), dict(scale=4)),
}


def _register():
    for name, (layers, bw, extra, block_args) in _RES2NET_DEFS.items():
        def fn(pretrained=False, *, _layers=layers, _bw=bw, _extra=extra,
               _ba=block_args, **kwargs):
            kwargs.pop("pretrained", None)
            ba = {**_ba, **kwargs.pop("block_args", {})}
            kwargs.setdefault("default_cfg", _cfg())
            return ResNet(block="bottle2neck", layers=tuple(_layers),
                          base_width=_bw, block_args=ba,
                          **{**_extra, **kwargs})
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name}."
        register_model(fn)


_register()
