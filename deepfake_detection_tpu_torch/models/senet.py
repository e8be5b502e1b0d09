"""Legacy SENet / SE-ResNet / SE-ResNeXt family (PyTorch, NCHW in
channels_last memory).

Counterpart of ``deepfake_detection_tpu/models/senet.py``: the standalone
:class:`SENet` with its four block kinds (``se``: SENet154's 1×1 to
2×planes then grouped 3×3 to 4×planes; ``se_resnet``: the stride on the
1×1; ``se_resnext``: width = planes × base_width / 64 × groups; ``basic``)
and its 9 names.  The residual add is ``se(out) + residual``, with no
zero-initialized BN; the stem is three 3×3s (SENet154) or one 7×7, then a
ceil-mode 3×3 max pool; layer1's shortcut is always a 1×1.

timm's names: the stem under ``layer0`` (``conv1``/``bn1`` …), the blocks'
``se_module.fc1``/``fc2`` (biased 1×1 convs), ``downsample.0``/``.1`` and
``last_linear``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2d
from ..ops.drop import dropout
from ..ops.linear import Linear
from ..ops.norm import BatchNorm2d
from ..ops.pool import SelectAdaptivePool2d, max_pool2d_torch
from ..registry import register_model
from .resnet import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

__all__ = ["SENet"]


def _cfg(**kwargs) -> Dict[str, Any]:
    cfg = dict(num_classes=1000, input_size=(3, 224, 224), pool_size=(7, 7),
               crop_pct=0.875, interpolation="bilinear",
               mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
               first_conv="layer0.conv1", classifier="last_linear")
    cfg.update(kwargs)
    return cfg


class _SEModule(nn.Module):
    """Squeeze-excite with biased 1×1 convs."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=True)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


_EXPANSION = {"se": 4, "se_resnet": 4, "se_resnext": 4, "basic": 1}


class _SENetBlock(nn.Module):
    """One residual block; ``kind`` picks the conv plan."""

    def __init__(self, kind: str, inplanes: int, planes: int, groups: int,
                 reduction: int, stride: int = 1,
                 has_downsample: bool = False, down_kernel_size: int = 1,
                 base_width: int = 4, bn: Optional[dict] = None):
        super().__init__()
        bn = bn or {}
        self.kind = kind
        if kind == "basic":
            out_chs = planes
            self.conv1 = Conv2d(inplanes, planes, 3, stride)
            self.bn1 = BatchNorm2d(planes, **bn)
            self.conv2 = Conv2d(planes, planes, 3, groups=groups)
            self.bn2 = BatchNorm2d(planes, **bn)
        else:
            out_chs = planes * 4
            if kind == "se":
                c1, s1, c2, s2 = planes * 2, 1, planes * 4, stride
            elif kind == "se_resnet":
                c1, s1, c2, s2 = planes, stride, planes, 1
            else:
                width = math.floor(planes * (base_width / 64)) * groups
                c1, s1, c2, s2 = width, 1, width, stride
            self.conv1 = Conv2d(inplanes, c1, 1, s1)
            self.bn1 = BatchNorm2d(c1, **bn)
            self.conv2 = Conv2d(c1, c2, 3, s2, groups=groups)
            self.bn2 = BatchNorm2d(c2, **bn)
            self.conv3 = Conv2d(c2, out_chs, 1)
            self.bn3 = BatchNorm2d(out_chs, **bn)
        self.se_module = _SEModule(out_chs, reduction)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, out_chs, down_kernel_size, stride),
            BatchNorm2d(out_chs, **bn)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.kind != "basic":
            y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.se_module(y) + residual)


class _Layer0(nn.Module):
    """The stem: three 3×3s (``input_3x3``) or one 7×7, each conv → BN →
    ReLU, then the ceil-mode max pool."""

    def __init__(self, in_chans: int, inplanes: int, input_3x3: bool,
                 bn: dict):
        super().__init__()
        if input_3x3:
            self.conv1 = Conv2d(in_chans, 64, 3, 2)
            self.bn1 = BatchNorm2d(64, **bn)
            self.conv2 = Conv2d(64, 64, 3)
            self.bn2 = BatchNorm2d(64, **bn)
            self.conv3 = Conv2d(64, inplanes, 3)
            self.bn3 = BatchNorm2d(inplanes, **bn)
            self.n = 3
        else:
            self.conv1 = Conv2d(in_chans, inplanes, 7, 2)
            self.bn1 = BatchNorm2d(inplanes, **bn)
            self.n = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n + 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return max_pool2d_torch(x, 3, 2, ceil_mode=True)


class SENet(nn.Module):
    """Generic SENet: ``layer0`` → four stages → pool → ``last_linear``."""

    def __init__(self, block: str = "se_resnet",
                 layers: Sequence[int] = (3, 4, 6, 3), groups: int = 1,
                 reduction: int = 16, num_classes: int = 1000,
                 in_chans: int = 3, inplanes: int = 128,
                 input_3x3: bool = True, down_kernel_size: int = 3,
                 drop_rate: float = 0.2, global_pool: str = "avg",
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 default_cfg: Optional[dict] = None):
        super().__init__()
        self.in_chans = in_chans
        self.drop_rate = drop_rate
        self.default_cfg = default_cfg
        bn = dict(momentum=bn_momentum, eps=bn_eps)
        self.layer0 = _Layer0(in_chans, inplanes, input_3x3, bn)
        exp = _EXPANSION[block]
        in_expanded = inplanes
        for si, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                    layers)):
            stride = 1 if si == 0 else 2
            dks = 1 if si == 0 else down_kernel_size
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                blocks.append(_SENetBlock(
                    block, in_expanded, planes, groups, reduction, s,
                    bi == 0 and (s != 1 or in_expanded != planes * exp),
                    dks, bn=bn))
                in_expanded = planes * exp
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.num_features = in_expanded
        self.avg_pool = SelectAdaptivePool2d(global_pool)
        self.last_linear = Linear(in_expanded * self.avg_pool.feat_mult(),
                                  num_classes) if num_classes > 0 else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False, pool: bool = True):
        """Logits for an NCHW batch; ``generator`` drives the dropout in
        train mode; ``features_only`` and ``pool`` as :class:`ResNet`'s."""
        if x.shape[1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        x = self.layer0(x)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        if features_only:
            return feats
        if not pool:
            return x
        x = self.avg_pool(x)
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, generator)
        return x if self.last_linear is None else self.last_linear(x)


# name: (block, layers, groups, extra kwargs); all but SENet154 take the
# 7×7 stem, 64 stem channels, 1×1 shortcuts and no dropout
_SMALL = dict(inplanes=64, input_3x3=False, down_kernel_size=1, drop_rate=0.0)
_SENET_DEFS = {
    "seresnet18": ("basic", (2, 2, 2, 2), 1, _SMALL),
    "seresnet34": ("basic", (3, 4, 6, 3), 1, _SMALL),
    "seresnet50": ("se_resnet", (3, 4, 6, 3), 1, _SMALL),
    "seresnet101": ("se_resnet", (3, 4, 23, 3), 1, _SMALL),
    "seresnet152": ("se_resnet", (3, 8, 36, 3), 1, _SMALL),
    "senet154": ("se", (3, 8, 36, 3), 64, {}),
    "seresnext26_32x4d": ("se_resnext", (2, 2, 2, 2), 32, _SMALL),
    "seresnext50_32x4d": ("se_resnext", (3, 4, 6, 3), 32, _SMALL),
    "seresnext101_32x4d": ("se_resnext", (3, 4, 23, 3), 32, _SMALL),
}


def _register():
    for name, (block, layers, groups, extra) in _SENET_DEFS.items():
        def fn(pretrained=False, *, _block=block, _layers=layers,
               _groups=groups, _extra=extra, **kwargs):
            kwargs.pop("pretrained", None)
            kwargs.setdefault("default_cfg", _cfg())
            return SENet(block=_block, layers=tuple(_layers), groups=_groups,
                         **{**_extra, **kwargs})
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name}."
        register_model(fn)


_register()
