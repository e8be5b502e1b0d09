"""Channel and spatial attention: SE, ECA, CECA, CBAM and Selective Kernel.

Counterpart of ``deepfake_detection_tpu/ops/attention.py``.  Tensors are
NCHW-shaped; the squeeze is a mean over dims (2, 3).  Parameter names are
timm's where timm has the module: ``fc1``/``fc2`` (SE, biased 1×1 convs),
``conv`` (ECA's 1-D conv, weight ``(1, 1, k)``; the JAX module's flax
kernel is ``(k, 1, 1)``), and the SK conv's ``paths.{i}.conv``/
``paths.{i}.bn`` and ``attn.fc_reduce``/``attn.bn``/``attn.fc_select``.
CBAM follows the JAX module (no BN after its spatial conv, unlike timm's):
``channel.fc1``/``channel.fc2`` and ``spatial.conv``.

As in the JAX package, the SK conv's BNs take the default momentum and eps
(they do not see the network's BN arguments).  ``create_attn`` needs the
channel count, which the flax modules read off their input.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .activations import get_act_fn
from .conv import Conv2d, cast_compute
from .norm import BatchNorm2d

__all__ = ["make_divisible", "SEModule", "EcaModule", "CecaModule",
           "ChannelAttn", "LightChannelAttn", "SpatialAttn",
           "LightSpatialAttn", "CbamModule", "LightCbamModule",
           "SelectiveKernelConv", "create_attn"]


def make_divisible(v: int, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Round channels to a multiple of ``divisor``, never below 90% of
    ``v``."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


class SEModule(nn.Module):
    """Squeeze-and-excitation: ``max(C // reduction, 8)`` hidden channels."""

    def __init__(self, channels: int, reduction: int = 16,
                 act: str = "relu"):
        super().__init__()
        rd = max(channels // reduction, 8)
        self.fc1 = Conv2d(channels, rd, 1, bias=True)
        self.fc2 = Conv2d(rd, channels, 1, bias=True)
        self.act_fn = get_act_fn(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(self.act_fn(self.fc1(_mean_hw(x))))
        return x * torch.sigmoid(s)


class Conv1d(nn.Conv1d):
    """ECA's channel conv (no bias) with the compute policy of
    :mod:`ops.conv`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = cast_compute(self.compute_dtype, x, self.weight)
        return F.conv1d(x, w, None, 1, self.padding)


def eca_kernel_size(channels: int, gamma: int = 2, beta: int = 1) -> int:
    t = int(abs(math.log(channels, 2) + beta) / gamma)
    return max(t if t % 2 else t + 1, 3)


class EcaModule(nn.Module):
    """Efficient channel attention: a 1-D conv over the channel descriptor,
    zero padded (SAME) at its ends."""

    circular = False

    def __init__(self, channels: int, kernel_size: Optional[int] = None,
                 gamma: int = 2, beta: int = 1):
        super().__init__()
        k = kernel_size or eca_kernel_size(channels, gamma, beta)
        self.kernel_size = k
        self.conv = Conv1d(1, 1, k, padding=0 if self.circular
                           else (k - 1) // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))[:, None, :]          # (B, 1, C)
        if self.circular:
            pad = (self.kernel_size - 1) // 2
            s = torch.cat([s[..., -pad:], s, s[..., :pad]], dim=-1)
        s = torch.sigmoid(self.conv(s))[:, 0]
        return x * s[:, :, None, None]


class CecaModule(EcaModule):
    """ECA with circular channel padding."""

    circular = True


class ChannelAttn(nn.Module):
    """CBAM's channel gate: one MLP over the avg- and the max-pooled
    descriptors, summed, sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        rd = channels // reduction
        self.fc1 = Conv2d(channels, rd, 1)
        self.fc2 = Conv2d(rd, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = _mean_hw(x)
        mx = x.amax(dim=(2, 3), keepdim=True)
        attn = self.fc2(F.relu(self.fc1(avg))) + \
            self.fc2(F.relu(self.fc1(mx)))
        return x * torch.sigmoid(attn)


class LightChannelAttn(ChannelAttn):
    """Light CBAM's channel gate: the MLP over half avg, half max."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = 0.5 * _mean_hw(x) + 0.5 * x.amax(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(pooled))))


class SpatialAttn(nn.Module):
    """CBAM's spatial gate: [mean, max] over channels → k×k conv → sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.cat([x.mean(dim=1, keepdim=True),
                          x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(stat))


class LightSpatialAttn(nn.Module):
    """Light CBAM's spatial gate: half mean, half max, one map."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv2d(1, 1, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = 0.5 * x.mean(dim=1, keepdim=True) + \
            0.5 * x.amax(dim=1, keepdim=True)
        return x * torch.sigmoid(self.conv(stat))


class CbamModule(nn.Module):
    """Channel then spatial attention."""

    def __init__(self, channels: int, reduction: int = 16,
                 spatial_kernel: int = 7):
        super().__init__()
        self.channel = ChannelAttn(channels, reduction)
        self.spatial = SpatialAttn(spatial_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial(self.channel(x))


class LightCbamModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16,
                 spatial_kernel: int = 7):
        super().__init__()
        self.channel = LightChannelAttn(channels, reduction)
        self.spatial = LightSpatialAttn(spatial_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial(self.channel(x))


class ConvBn(nn.Module):
    """A conv and its BN (timm's ``ConvBnAct`` names ``conv``/``bn``); the
    activation is the caller's."""

    def __init__(self, conv: nn.Module, bn: nn.Module):
        super().__init__()
        self.conv = conv
        self.bn = bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class _SelectiveKernelAttn(nn.Module):
    """The paths' weights ``(B, paths, C, 1, 1)``: a softmax over the paths
    of a bottleneck read off the mean of their sum."""

    def __init__(self, channels: int, num_paths: int, attn_channels: int,
                 act_fn):
        super().__init__()
        self.num_paths, self.channels = num_paths, channels
        self.act_fn = act_fn
        self.fc_reduce = Conv2d(channels, attn_channels, 1)
        self.bn = BatchNorm2d(attn_channels)
        self.fc_select = Conv2d(attn_channels, channels * num_paths, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        s = self.act_fn(self.bn(self.fc_reduce(_mean_hw(feats.sum(dim=1)))))
        s = self.fc_select(s).view(s.shape[0], self.num_paths,
                                   self.channels, 1, 1)
        return torch.softmax(s, dim=1)


class SelectiveKernelConv(nn.Module):
    """SK conv: parallel conv → BN → act paths of different kernels (3×3s
    dilated in their place under ``keep_3x3``), each on the whole input or
    on its own channel split (``split_input``), mixed by a softmax over the
    paths of an attention read off their sum."""

    def __init__(self, in_chs: int, out_chs: int,
                 kernel_size: Sequence[int] = (3, 5), stride: int = 1,
                 dilation: int = 1, groups: int = 1,
                 attn_reduction: int = 16, min_attn_channels: int = 32,
                 keep_3x3: bool = True, split_input: bool = False,
                 act: str = "relu"):
        super().__init__()
        kernel_sizes = list(kernel_size)
        dilations = [dilation] * len(kernel_sizes)
        if keep_3x3:
            dilations = [max(dilation * (k - 1) // 2, 1)
                         for k in kernel_sizes]
            kernel_sizes = [3] * len(kernel_sizes)
        n = len(kernel_sizes)
        if split_input and in_chs % n:
            raise ValueError(f"split_input: {in_chs} channels into {n} "
                             f"paths")
        path_in = in_chs // n if split_input else in_chs
        g = min(groups if groups > 0 else 1, out_chs)
        self.split_input = split_input
        self.act_fn = get_act_fn(act)
        self.paths = nn.ModuleList(
            ConvBn(Conv2d(path_in, out_chs, k, stride, dilation=d, groups=g),
                   BatchNorm2d(out_chs))
            for k, d in zip(kernel_sizes, dilations))
        self.attn = _SelectiveKernelAttn(
            out_chs, n, max(out_chs // attn_reduction, min_attn_channels),
            self.act_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.paths)
        xs = torch.chunk(x, n, dim=1) if self.split_input else [x] * n
        feats = torch.stack([self.act_fn(path(xi))
                             for path, xi in zip(self.paths, xs)], dim=1)
        return (feats * self.attn(feats)).sum(dim=1)


_ATTN = {"se": SEModule, "eca": EcaModule, "ceca": CecaModule,
         "cbam": CbamModule, "lcbam": LightCbamModule}


def create_attn(attn_type, channels: int, **kwargs) -> Optional[nn.Module]:
    """Name (or a module class) → the attention module on ``channels``;
    None or ``''`` → None."""
    if attn_type is None or attn_type == "":
        return None
    if callable(attn_type) and not isinstance(attn_type, str):
        return attn_type(channels, **kwargs)
    name = attn_type.lower()
    if name not in _ATTN:
        raise KeyError(f"Unknown attention {attn_type!r}")
    return _ATTN[name](channels, **kwargs)
