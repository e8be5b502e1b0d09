"""EfficientNet building blocks (PyTorch, NCHW in channels_last memory).

Counterpart of ``deepfake_detection_tpu/models/efficientnet_blocks.py``:
channel rounding, ``SqueezeExcite``, ``ConvBnAct``,
``DepthwiseSeparableConv`` and ``InvertedResidual``, with timm's module
names (``conv_dw``, ``bn1``, ``se.conv_reduce``, ...) so state dicts carry
timm's keys.

Every depthwise stage goes through :func:`ops.depthwise.fused_depthwise`
(dw conv → BN → act in one kernel on the card); the port has no switch for
it.  Eval folds the BN running stats into the kernel's affine epilogue.
Train mode runs the kernel with an identity epilogue (its pre-norm ``z``)
and normalizes with the batch statistics afterwards, as the JAX package's
``_fused_dw_bn_act`` training branch does.  ``norm_layer="split<k>"``
(``--split-bn``) builds every BN as a :class:`~ops.norm.SplitBatchNorm2d`
of ``k`` splits; its dw stages keep the kernel (the JAX package sends them
to the XLA composition instead, the same convolution): ``z`` then the
split BN then the activation in training, the main BN folded in eval.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ..ops.activations import get_act_fn
from ..ops.conv import create_conv2d
from ..ops.depthwise import FUSED_DW_ACTS, fused_depthwise
from ..ops.drop import DropPath
from ..ops.norm import BatchNorm2d, SplitBatchNorm2d

__all__ = ["make_divisible", "round_channels", "fused_dw_eligible",
           "SqueezeExcite", "ConvBnAct", "DepthwiseSeparableConv",
           "InvertedResidual"]


def make_divisible(v, divisor: int = 8, min_value: Optional[int] = None) -> int:
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_channels(channels, multiplier: float = 1.0, divisor: int = 8,
                   channel_min: Optional[int] = None) -> int:
    """Scale + round channel count."""
    if not multiplier:
        return channels
    return make_divisible(channels * multiplier, divisor, channel_min)


def _norm(norm_layer: str, chs: int, momentum: float, eps: float) -> nn.Module:
    if norm_layer.startswith("split"):
        # AdvProp split BN, 'split<k>' (k defaults to 2)
        return SplitBatchNorm2d(chs, momentum=momentum, eps=eps,
                                num_splits=int(norm_layer[5:] or 2))
    if norm_layer == "bn":
        return BatchNorm2d(chs, momentum=momentum, eps=eps)
    if norm_layer == "none":
        return nn.Identity()
    raise NotImplementedError(
        f"norm_layer {norm_layer!r} is not ported (bn, split<k>, none)")


def fused_dw_eligible(dw_kernel_size, dilation: int, stride,
                      norm_layer: str) -> bool:
    """Whether a dw stage fits the fused op: one square k3 or k5 kernel, no
    dilation, stride 1 or 2, plain BN, split BN or no norm.  The port
    routes every dw stage through the op, so a block that is not eligible
    is not built."""
    return (isinstance(dw_kernel_size, int) and dw_kernel_size in (3, 5)
            and int(dilation) == 1 and int(stride) in (1, 2)
            and (norm_layer in ("bn", "none")
                 or norm_layer.startswith("split")))


def _check_eligible(dw_kernel_size, dilation, stride, norm_layer) -> None:
    if not fused_dw_eligible(dw_kernel_size, dilation, stride, norm_layer):
        raise NotImplementedError(
            f"depthwise stage k={dw_kernel_size} dilation={dilation} "
            f"stride={stride} norm={norm_layer!r} does not fit the fused "
            f"depthwise op, and no other depthwise path is ported")


def _fused_dw_bn_act(x: torch.Tensor, conv_dw: nn.Module, bn: nn.Module,
                     act: Any, pad_type) -> torch.Tensor:
    """dw conv → BN → act through :func:`fused_depthwise`.

    ``x`` is NCHW in channels_last memory, so ``x.permute(0, 2, 3, 1)`` is
    the kernel's NHWC layout without a copy, and the NHWC result permutes
    back to NCHW channels_last the same way."""
    k = conv_dw.kernel_size[0]
    # (C, 1, k, k) → (k, k, C): a k²·C-float layout change of the weight
    w = conv_dw.weight[:, 0].permute(1, 2, 0).contiguous()
    act_name = "silu" if act in ("silu", "swish") else act
    kern_act = act_name if act_name in FUSED_DW_ACTS else "none"
    act_fn = get_act_fn(act)
    x_nhwc = x.permute(0, 2, 3, 1)
    # a SplitBatchNorm2d is a BatchNorm2d: in training it splits z's rows
    # among its BNs, in eval its main BN folds into the epilogue
    if isinstance(bn, BatchNorm2d) and bn.training:
        z = fused_depthwise(x_nhwc, w, None, None, stride=conv_dw.stride,
                            padding=pad_type, act="none")
        return act_fn(bn(z.permute(0, 3, 1, 2)))
    scale, shift = bn.folded() if isinstance(bn, BatchNorm2d) else (None,
                                                                    None)
    y = fused_depthwise(x_nhwc, w, scale, shift, stride=conv_dw.stride,
                        padding=pad_type, act=kern_act).permute(0, 3, 1, 2)
    return y if kern_act == act_name else act_fn(y)


class SqueezeExcite(nn.Module):
    """EfficientNet-style SE: the reduction is computed from
    ``reduced_base_chs`` (the block *input* chs), not the expanded chs."""

    def __init__(self, chs: int, se_ratio: float = 0.25,
                 reduced_base_chs: Optional[int] = None, act: Any = "relu",
                 gate_fn: Any = "sigmoid", divisor: int = 1):
        super().__init__()
        reduced_chs = make_divisible((reduced_base_chs or chs) * se_ratio,
                                     divisor)
        self.conv_reduce = create_conv2d(chs, reduced_chs, 1, bias=True)
        self.act_fn = get_act_fn(act)
        self.conv_expand = create_conv2d(reduced_chs, chs, 1, bias=True)
        self.gate_fn = get_act_fn(gate_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(self.act_fn(self.conv_reduce(s)))
        return x * self.gate_fn(s)


class ConvBnAct(nn.Module):
    """conv → norm → act."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size=3,
                 stride: int = 1, dilation: int = 1, pad_type: str = "",
                 act: Any = "relu", norm_layer: str = "bn",
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.out_chs = out_chs
        self.conv = create_conv2d(in_chs, out_chs, kernel_size, stride=stride,
                                  dilation=dilation, padding=pad_type)
        self.bn1 = _norm(norm_layer, out_chs, bn_momentum, bn_eps)
        self.act_fn = get_act_fn(act)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.act_fn(self.bn1(self.conv(x)))


def _se(chs: int, se_ratio: float, base: int, act, se_gate_fn,
        sek: dict) -> SqueezeExcite:
    return SqueezeExcite(chs, se_ratio, reduced_base_chs=base,
                         act=sek.pop("act", act),
                         gate_fn=sek.pop("gate_fn", se_gate_fn),
                         divisor=sek.pop("divisor", 1))


class DepthwiseSeparableConv(nn.Module):
    """dw conv → SE → pw conv; used where the MBConv expansion is 1."""

    def __init__(self, in_chs: int, out_chs: int, dw_kernel_size=3,
                 stride: int = 1, dilation: int = 1, pad_type: str = "",
                 act: Any = "relu", noskip: bool = False,
                 pw_kernel_size: int = 1, pw_act: bool = False,
                 se_ratio: float = 0.0, se_gate_fn: Any = "sigmoid",
                 se_kwargs: Any = None, drop_path_rate: float = 0.0,
                 norm_layer: str = "bn", bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5):
        super().__init__()
        _check_eligible(dw_kernel_size, dilation, stride, norm_layer)
        self.out_chs = out_chs
        self.has_residual = stride == 1 and in_chs == out_chs and not noskip
        self.pad_type = pad_type
        self.act = act
        self.act_fn = get_act_fn(act)
        self.pw_act = pw_act
        self.conv_dw = create_conv2d(in_chs, in_chs, dw_kernel_size,
                                     stride=stride, padding=pad_type,
                                     depthwise=True)
        self.bn1 = _norm(norm_layer, in_chs, bn_momentum, bn_eps)
        if se_ratio > 0.0:
            sek = dict(se_kwargs or {})
            sek.pop("reduce_mid", None)   # dw block: mid == in chs
            self.se = _se(in_chs, se_ratio, in_chs, act, se_gate_fn, sek)
        else:
            self.se = None
        self.conv_pw = create_conv2d(in_chs, out_chs, pw_kernel_size,
                                     padding=pad_type)
        self.bn2 = _norm(norm_layer, out_chs, bn_momentum, bn_eps)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        shortcut = x
        x = _fused_dw_bn_act(x, self.conv_dw, self.bn1, self.act,
                             self.pad_type)
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pw(x))
        if self.pw_act:
            x = self.act_fn(x)
        if self.has_residual:
            x = self.drop_path(x, generator) + shortcut
        return x


class InvertedResidual(nn.Module):
    """MBConv: pw expand → BN → act → dw → BN → act → SE → pw linear → BN."""

    def __init__(self, in_chs: int, out_chs: int, dw_kernel_size=3,
                 stride: int = 1, dilation: int = 1, pad_type: str = "",
                 act: Any = "relu", noskip: bool = False,
                 exp_ratio: float = 1.0, exp_kernel_size: int = 1,
                 pw_kernel_size: int = 1, se_ratio: float = 0.0,
                 se_gate_fn: Any = "sigmoid", se_kwargs: Any = None,
                 drop_path_rate: float = 0.0, norm_layer: str = "bn",
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        _check_eligible(dw_kernel_size, dilation, stride, norm_layer)
        mid_chs = make_divisible(in_chs * exp_ratio)
        self.out_chs = out_chs
        self.has_residual = in_chs == out_chs and stride == 1 and not noskip
        self.pad_type = pad_type
        self.act = act
        self.act_fn = get_act_fn(act)
        self.conv_pw = create_conv2d(in_chs, mid_chs, exp_kernel_size,
                                     padding=pad_type)
        self.bn1 = _norm(norm_layer, mid_chs, bn_momentum, bn_eps)
        self.conv_dw = create_conv2d(mid_chs, mid_chs, dw_kernel_size,
                                     stride=stride, padding=pad_type,
                                     depthwise=True)
        self.bn2 = _norm(norm_layer, mid_chs, bn_momentum, bn_eps)
        if se_ratio > 0.0:
            sek = dict(se_kwargs or {})
            base = mid_chs if sek.pop("reduce_mid", False) else in_chs
            self.se = _se(mid_chs, se_ratio, base, act, se_gate_fn, sek)
        else:
            self.se = None
        self.conv_pwl = create_conv2d(mid_chs, out_chs, pw_kernel_size,
                                      padding=pad_type)
        self.bn3 = _norm(norm_layer, out_chs, bn_momentum, bn_eps)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        shortcut = x
        x = self.act_fn(self.bn1(self.conv_pw(x)))
        x = _fused_dw_bn_act(x, self.conv_dw, self.bn2, self.act,
                             self.pad_type)
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        if self.has_residual:
            x = self.drop_path(x, generator) + shortcut
        return x
