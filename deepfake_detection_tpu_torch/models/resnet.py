"""ResNet / ResNeXt / SE-ResNeXt / ECA-ResNet family (PyTorch, NCHW in
channels_last memory).

Counterpart of ``deepfake_detection_tpu/models/resnet.py``: the generic
``ResNet`` with every stem (7×7, ``deep``, ``deep_tiered``,
``deep_tiered_narrow``), the conv or avg-pool (``avg_down``) projection
shortcut, cardinality and base width (ResNeXt), SE / ECA block attention
(``ops/attention.py``), ``output_stride`` 16 / 8 dilation, DropBlock on
layers 3–4 (gamma scale 0.25 and 1.0), drop path, the last BN of each
block zero-initialized (``zero_init_last_bn``), and the 40 names of the
JAX module.  :func:`register_block` lets ``res2net`` and ``sknet`` plug
their blocks into the same ``ResNet``.

Parameter names are timm's: ``conv1`` (a ``Sequential`` with convs at
0/3/6 and BNs at 1/4 for a deep stem), ``bn1``, ``layer{1-4}.{b}.conv1``
… ``bn3``, ``.se``, ``.downsample.0``/``.1`` (conv, BN) or, under
``avg_down``, ``.downsample.1``/``.2`` after the pool, and ``fc``.  BN is
``ops/norm.py``'s (flax statistics) with the JAX module's momentum 0.1 and
eps 1e-5; the factory drops ``bn_*`` arguments for these families, as the
JAX factory does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.activations import get_act_fn
from ..ops.attention import Conv1d, create_attn
from ..ops.conv import Conv2d, dense_init_goog
from ..ops.drop import DropBlock2d, drop_path, dropout
from ..ops.linear import Linear
from ..ops.norm import BatchNorm2d
from ..ops.pool import SelectAdaptivePool2d, avg_pool2d_same, max_pool2d_torch
from ..registry import register_model

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "register_block",
           "init_weights"]

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def _cfg(**kwargs) -> Dict[str, Any]:
    cfg = dict(num_classes=1000, input_size=(3, 224, 224), pool_size=(7, 7),
               crop_pct=0.875, interpolation="bilinear",
               mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
               first_conv="conv1", classifier="fc")
    cfg.update(kwargs)
    return cfg


class Act(nn.Module):
    """An activation as a module (the deep stem's ``Sequential`` slot)."""

    def __init__(self, act: str = "relu"):
        super().__init__()
        self.fn = get_act_fn(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class AvgPoolSame(nn.Module):
    """The ``avg_down`` shortcut's 2×2 pool (TF SAME, pads not counted)."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2d_same(x, 2, self.stride, count_include_pad=False)


def make_downsample(in_chs: int, out_chs: int, kernel_size: int = 1,
                    stride: int = 1, dilation: int = 1,
                    first_dilation: Optional[int] = None, avg: bool = False,
                    bn: Optional[dict] = None) -> nn.Sequential:
    """The projection shortcut: conv → BN, or pool → 1×1 conv → BN."""
    bn = bn or {}
    if avg:
        avg_stride = stride if dilation == 1 else 1
        pool = nn.Identity() if stride == 1 and dilation == 1 \
            else AvgPoolSame(avg_stride)
        return nn.Sequential(pool, Conv2d(in_chs, out_chs, 1),
                             BatchNorm2d(out_chs, **bn))
    ks = 1 if stride == 1 and dilation == 1 else kernel_size
    fd = (first_dilation or dilation) if ks > 1 else 1
    return nn.Sequential(Conv2d(in_chs, out_chs, ks, stride, dilation=fd),
                         BatchNorm2d(out_chs, **bn))


class _Block(nn.Module):
    """What every residual block of the generic ResNet shares: its
    arguments, DropBlock and drop path, the attention, the shortcut and the
    last add.  A subclass builds its convs, then calls :meth:`_tail`."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, cardinality: int = 1,
                 base_width: int = 64, reduce_first: int = 1,
                 dilation: int = 1, first_dilation: Optional[int] = None,
                 act: str = "relu", attn_layer: Optional[str] = None,
                 avg_down: bool = False, down_kernel_size: int = 1,
                 drop_block_rate: float = 0.0, drop_block_gamma: float = 1.0,
                 drop_path_rate: float = 0.0, zero_init_last_bn: bool = True,
                 bn: Optional[dict] = None):
        super().__init__()
        self.inplanes, self.planes, self.stride = inplanes, planes, stride
        self.cardinality, self.base_width = cardinality, base_width
        self.reduce_first, self.dilation = reduce_first, dilation
        self.first_dilation = first_dilation or dilation
        self.has_downsample, self.act = has_downsample, act
        self.outplanes = planes * self.expansion
        self.bn_args = dict(bn or {})
        self.act_fn = get_act_fn(act)
        self.drop_path_rate = drop_path_rate
        self.zero_init_last_bn = zero_init_last_bn
        self.attn_layer, self.avg_down = attn_layer, avg_down
        self.down_kernel_size = down_kernel_size
        self.drop_block = (drop_block_rate, drop_block_gamma)
        self.shortcut_dilation = (dilation, first_dilation)

    def _tail(self, n_drop_blocks: int, last_bn: nn.Module) -> None:
        """The DropBlocks (``db1`` … after each conv's BN), the attention
        (``se``) and the shortcut (``downsample``), after the convs."""
        last_bn.zero_init = self.zero_init_last_bn
        rate, gamma = self.drop_block
        for i in range(1, n_drop_blocks + 1):
            setattr(self, f"db{i}", DropBlock2d(rate, 7, gamma)
                    if rate else None)
        self.se = create_attn(self.attn_layer, self.outplanes)
        self.downsample = make_downsample(
            self.inplanes, self.outplanes, self.down_kernel_size,
            self.stride, *self.shortcut_dilation, self.avg_down,
            self.bn_args) if self.has_downsample else None

    @staticmethod
    def _db(db: Optional[nn.Module], x: torch.Tensor, generator):
        return x if db is None else db(x, generator)

    def _finish(self, y: torch.Tensor, x: torch.Tensor,
                generator) -> torch.Tensor:
        if self.se is not None:
            y = self.se(y)
        if self.training and self.drop_path_rate:
            y = drop_path(y, self.drop_path_rate, generator)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act_fn(y + residual)


class BasicBlock(_Block):
    """3×3 + 3×3, expansion 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, **kw):
        super().__init__(inplanes, planes, **kw)
        if self.cardinality != 1 or self.base_width != 64:
            raise ValueError("BasicBlock takes cardinality 1, base width 64")
        first = planes // self.reduce_first
        self.conv1 = Conv2d(inplanes, first, 3, self.stride,
                            dilation=self.first_dilation)
        self.bn1 = BatchNorm2d(first, **self.bn_args)
        self.conv2 = Conv2d(first, self.outplanes, 3, dilation=self.dilation)
        self.bn2 = BatchNorm2d(self.outplanes, **self.bn_args)
        self._tail(2, self.bn2)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.act_fn(self._db(self.db1, self.bn1(self.conv1(x)),
                                 generator))
        y = self._db(self.db2, self.bn2(self.conv2(y)), generator)
        return self._finish(y, x, generator)


class Bottleneck(_Block):
    """1×1 → 3×3 (grouped) → 1×1, expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, **kw):
        super().__init__(inplanes, planes, **kw)
        width = int(math.floor(planes * (self.base_width / 64))
                    * self.cardinality)
        first = width // self.reduce_first
        self.conv1 = Conv2d(inplanes, first, 1)
        self.bn1 = BatchNorm2d(first, **self.bn_args)
        self.conv2 = Conv2d(first, width, 3, self.stride,
                            dilation=self.first_dilation,
                            groups=self.cardinality)
        self.bn2 = BatchNorm2d(width, **self.bn_args)
        self.conv3 = Conv2d(width, self.outplanes, 1)
        self.bn3 = BatchNorm2d(self.outplanes, **self.bn_args)
        self._tail(3, self.bn3)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.act_fn(self._db(self.db1, self.bn1(self.conv1(x)),
                                 generator))
        y = self.act_fn(self._db(self.db2, self.bn2(self.conv2(y)),
                                 generator))
        y = self._db(self.db3, self.bn3(self.conv3(y)), generator)
        return self._finish(y, x, generator)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def register_block(name: str, cls) -> None:
    """Register an extra residual block type for :class:`ResNet`."""
    _BLOCKS[name] = cls


class ResNet(nn.Module):
    """Generic ResNet: stem → max pool → four stages → pool → fc."""

    def __init__(self, block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, in_chans: int = 3,
                 cardinality: int = 1, base_width: int = 64,
                 stem_width: int = 64, stem_type: str = "",
                 block_reduce_first: int = 1, down_kernel_size: int = 1,
                 avg_down: bool = False, output_stride: int = 32,
                 act: str = "relu", attn_layer: Optional[str] = None,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 drop_block_rate: float = 0.0, global_pool: str = "avg",
                 zero_init_last_bn: bool = True,
                 block_args: Optional[dict] = None, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5,
                 default_cfg: Optional[dict] = None):
        super().__init__()
        self.in_chans = in_chans
        self.drop_rate = drop_rate
        self.default_cfg = default_cfg
        self.act_fn = get_act_fn(act)
        bn = dict(momentum=bn_momentum, eps=bn_eps)
        deep_stem = "deep" in stem_type
        inplanes = stem_width * 2 if deep_stem else 64
        if deep_stem:
            c1 = c2 = stem_width
            if "tiered" in stem_type:
                c1 = 3 * (stem_width // 4)
                c2 = stem_width if "narrow" in stem_type \
                    else 6 * (stem_width // 4)
            self.conv1 = nn.Sequential(
                Conv2d(in_chans, c1, 3, 2), BatchNorm2d(c1, **bn), Act(act),
                Conv2d(c1, c2, 3), BatchNorm2d(c2, **bn), Act(act),
                Conv2d(c2, inplanes, 3))
        else:
            self.conv1 = Conv2d(in_chans, inplanes, 7, 2)
        self.bn1 = BatchNorm2d(inplanes, **bn)

        block_cls = _BLOCKS[block]
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
        if output_stride == 16:
            strides[3], dilations[3] = 1, 2
        elif output_stride == 8:
            strides[2:4], dilations[2:4] = [1, 1], [2, 4]
        elif output_stride != 32:
            raise ValueError(f"output_stride {output_stride}: 8, 16 or 32")
        in_expanded, prev_dilation = inplanes, 1
        for si, (chs, n_blocks, stride, dilation) in enumerate(
                zip((64, 128, 256, 512), layers, strides, dilations)):
            # DropBlock on layers 3 and 4 only, gamma scale 0.25 / 1.0
            db = drop_block_rate if si >= 2 else 0.0
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                kw = dict(
                    stride=s, has_downsample=bi == 0 and (
                        s != 1 or in_expanded != chs * block_cls.expansion),
                    cardinality=cardinality, base_width=base_width,
                    reduce_first=block_reduce_first, dilation=dilation,
                    first_dilation=prev_dilation if bi == 0 else dilation,
                    act=act, attn_layer=attn_layer, avg_down=avg_down,
                    down_kernel_size=down_kernel_size, drop_block_rate=db,
                    drop_block_gamma=0.25 if si == 2 else 1.0,
                    drop_path_rate=drop_path_rate,
                    zero_init_last_bn=zero_init_last_bn, bn=bn)
                kw.update(block_args or {})
                blocks.append(block_cls(in_expanded, chs, **kw))
                in_expanded = chs * block_cls.expansion
            prev_dilation = dilation
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.num_features = in_expanded
        self.global_pool = SelectAdaptivePool2d(global_pool)
        self.fc = Linear(in_expanded * self.global_pool.feat_mult(),
                         num_classes) if num_classes > 0 else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False, pool: bool = True):
        """Logits for an NCHW batch; ``generator`` drives DropBlock, drop
        path and dropout in train mode.  ``features_only`` returns each
        stage's output, ``pool=False`` the last map, as the JAX module's
        arguments."""
        if x.shape[1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        x = self.act_fn(self.bn1(self.conv1(x)))
        x = max_pool2d_torch(x, 3, 2, padding=1)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, generator)
            feats.append(x)
        if features_only:
            return feats
        if not pool:
            return x
        x = self.global_pool(x)
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, generator)
        return x if self.fc is None else self.fc(x)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in module order: He (fan-out) convs, as timm's and the
    JAX module's; unit BN, zero where a block's last BN is
    zero-initialized; ECA's channel conv N(0, 1/k) and dense layers
    U(±1/sqrt(out)) with zero bias."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv2d, BatchNorm2d)):
                m.reset_parameters(generator)
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
            elif isinstance(m, Conv1d):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[-1]),
                                 generator=generator)
            elif isinstance(m, nn.Linear):
                dense_init_goog(m.weight, generator)
                m.bias.zero_()
    return model


def _resnet(block, layers, **kwargs) -> ResNet:
    kwargs.pop("pretrained", None)
    kwargs.setdefault("default_cfg", _cfg())
    return ResNet(block=block, layers=tuple(layers), **kwargs)


_RESNET_DEFS = {
    # name: (block, layers, extra kwargs)
    "resnet18": ("basic", (2, 2, 2, 2), {}),
    "resnet34": ("basic", (3, 4, 6, 3), {}),
    "resnet26": ("bottleneck", (2, 2, 2, 2), {}),
    "resnet26d": ("bottleneck", (2, 2, 2, 2),
                  dict(stem_width=32, stem_type="deep", avg_down=True)),
    "resnet50": ("bottleneck", (3, 4, 6, 3), {}),
    "resnet50d": ("bottleneck", (3, 4, 6, 3),
                  dict(stem_width=32, stem_type="deep", avg_down=True)),
    "resnet101": ("bottleneck", (3, 4, 23, 3), {}),
    "resnet152": ("bottleneck", (3, 8, 36, 3), {}),
    "tv_resnet34": ("basic", (3, 4, 6, 3), {}),
    "tv_resnet50": ("bottleneck", (3, 4, 6, 3), {}),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), dict(base_width=128)),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), dict(base_width=128)),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3),
                        dict(cardinality=32, base_width=4)),
    "resnext50d_32x4d": ("bottleneck", (3, 4, 6, 3),
                         dict(cardinality=32, base_width=4, stem_width=32,
                              stem_type="deep", avg_down=True)),
    "resnext101_32x4d": ("bottleneck", (3, 4, 23, 3),
                         dict(cardinality=32, base_width=4)),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3),
                         dict(cardinality=32, base_width=8)),
    "resnext101_64x4d": ("bottleneck", (3, 4, 23, 3),
                         dict(cardinality=64, base_width=4)),
    "tv_resnext50_32x4d": ("bottleneck", (3, 4, 6, 3),
                           dict(cardinality=32, base_width=4)),
    "ig_resnext101_32x8d": ("bottleneck", (3, 4, 23, 3),
                            dict(cardinality=32, base_width=8)),
    "ig_resnext101_32x16d": ("bottleneck", (3, 4, 23, 3),
                             dict(cardinality=32, base_width=16)),
    "ig_resnext101_32x32d": ("bottleneck", (3, 4, 23, 3),
                             dict(cardinality=32, base_width=32)),
    "ig_resnext101_32x48d": ("bottleneck", (3, 4, 23, 3),
                             dict(cardinality=32, base_width=48)),
    "ssl_resnet18": ("basic", (2, 2, 2, 2), {}),
    "ssl_resnet50": ("bottleneck", (3, 4, 6, 3), {}),
    "ssl_resnext50_32x4d": ("bottleneck", (3, 4, 6, 3),
                            dict(cardinality=32, base_width=4)),
    "ssl_resnext101_32x4d": ("bottleneck", (3, 4, 23, 3),
                             dict(cardinality=32, base_width=4)),
    "ssl_resnext101_32x8d": ("bottleneck", (3, 4, 23, 3),
                             dict(cardinality=32, base_width=8)),
    "ssl_resnext101_32x16d": ("bottleneck", (3, 4, 23, 3),
                              dict(cardinality=32, base_width=16)),
    "swsl_resnet18": ("basic", (2, 2, 2, 2), {}),
    "swsl_resnet50": ("bottleneck", (3, 4, 6, 3), {}),
    "swsl_resnext50_32x4d": ("bottleneck", (3, 4, 6, 3),
                             dict(cardinality=32, base_width=4)),
    "swsl_resnext101_32x4d": ("bottleneck", (3, 4, 23, 3),
                              dict(cardinality=32, base_width=4)),
    "swsl_resnext101_32x8d": ("bottleneck", (3, 4, 23, 3),
                              dict(cardinality=32, base_width=8)),
    "swsl_resnext101_32x16d": ("bottleneck", (3, 4, 23, 3),
                               dict(cardinality=32, base_width=16)),
    "seresnext26d_32x4d": ("bottleneck", (2, 2, 2, 2),
                           dict(cardinality=32, base_width=4, stem_width=32,
                                stem_type="deep", avg_down=True,
                                attn_layer="se")),
    "seresnext26t_32x4d": ("bottleneck", (2, 2, 2, 2),
                           dict(cardinality=32, base_width=4, stem_width=32,
                                stem_type="deep_tiered", avg_down=True,
                                attn_layer="se")),
    "seresnext26tn_32x4d": ("bottleneck", (2, 2, 2, 2),
                            dict(cardinality=32, base_width=4, stem_width=32,
                                 stem_type="deep_tiered_narrow",
                                 avg_down=True, attn_layer="se")),
    "ecaresnext26tn_32x4d": ("bottleneck", (2, 2, 2, 2),
                             dict(cardinality=32, base_width=4, stem_width=32,
                                  stem_type="deep_tiered_narrow",
                                  avg_down=True, attn_layer="eca")),
    "ecaresnet18": ("basic", (2, 2, 2, 2), dict(attn_layer="eca")),
    "ecaresnet50": ("bottleneck", (3, 4, 6, 3), dict(attn_layer="eca")),
}


def _register_resnets():
    for name, (block, layers, extra) in _RESNET_DEFS.items():
        def fn(pretrained=False, *, _block=block, _layers=layers,
               _extra=extra, **kwargs):
            return _resnet(_block, _layers, **{**_extra, **kwargs})
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name}."
        register_model(fn)


_register_resnets()
