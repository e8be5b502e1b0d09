"""Convolutions: padding resolution, plain and depthwise ``Conv2d``.

Counterpart of ``deepfake_detection_tpu/ops/conv.py`` (``resolve_padding``,
``Conv2d``, ``create_conv2d`` for plain and depthwise kernels, the goog
initializers).  Tensors are NCHW-shaped, held in ``torch.channels_last``
memory; weights are OIHW with timm's parameter names (``weight``, ``bias``).

Padding carries checkpoint-parity semantics: pad_type ``''`` is the
reference's STATIC symmetric torch padding, ``'same'`` is TF SAME (padding
depends on the input size and may be asymmetric), ``'valid'`` none, an int
explicit symmetric padding.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["resolve_padding", "explicit_padding", "conv_kernel_init_goog",
           "dense_init_goog", "Conv2d", "create_conv2d"]


def _to_tuple(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def resolve_padding(padding: Union[str, int, None], kernel_size, dilation=1,
                    stride=1):
    """Map reference pad_type strings onto padding specs.

    ``''`` → the static symmetric ``((s-1) + d*(k-1)) // 2`` per side, as
    ``[(lo, hi), (lo, hi)]``; ``'same'`` → ``"SAME"``; ``'valid'`` →
    ``"VALID"``; int → explicit symmetric; anything else passes through.
    """
    if padding is None or padding == "":
        ks, dl, st = _to_tuple(kernel_size), _to_tuple(dilation), \
            _to_tuple(stride)
        return [(p, p) for p in
                (((s - 1) + d * (k - 1)) // 2 for k, d, s in zip(ks, dl, st))]
    if str(padding).lower() == "same":
        return "SAME"
    if str(padding).lower() == "valid":
        return "VALID"
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    return padding


def explicit_padding(padding, kernel_size, dilation, stride, h: int,
                     w: int) -> Tuple[int, int, int, int]:
    """``(top, bottom, left, right)`` for an input of spatial size ``h×w``:
    :func:`resolve_padding`, with TF SAME worked out for this size."""
    pad = resolve_padding(padding, kernel_size, dilation, stride)
    if pad == "SAME":
        ks, dl, st = _to_tuple(kernel_size), _to_tuple(dilation), \
            _to_tuple(stride)
        pad = []
        for n, k, d, s in zip((h, w), ks, dl, st):
            need = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pad.append((need // 2, need - need // 2))
    elif pad == "VALID":
        pad = [(0, 0), (0, 0)]
    (t, b), (l, r) = [tuple(int(p) for p in pr) for pr in pad]
    return t, b, l, r


def conv_kernel_init_goog(weight: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """TF/EfficientNet conv init in place: N(0, sqrt(2/fan_out)),
    fan_out = kh*kw*out of the OIHW ``weight`` (the JAX package's
    ``kh*kw*out`` of HWIO, depthwise included)."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                              generator=generator)


def dense_init_goog(weight: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """TF head init in place: U(-1/sqrt(out), 1/sqrt(out)) of the
    ``(out, in)`` ``weight``."""
    init_range = 1.0 / math.sqrt(weight.shape[0])
    with torch.no_grad():
        return weight.uniform_(-init_range, init_range, generator=generator)


class Conv2d(nn.Module):
    """Conv with reference padding semantics; depthwise via ``groups ==
    in_chs``.  Parameters ``weight`` (OIHW) and optional ``bias``."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size=3, stride=1,
                 dilation=1, groups: int = 1,
                 padding: Union[str, int, None] = "", bias: bool = False):
        super().__init__()
        kh, kw = _to_tuple(kernel_size)
        self.kernel_size = (kh, kw)
        self.stride = _to_tuple(stride)
        self.dilation = _to_tuple(dilation)
        self.groups = groups
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_chs, in_chs // groups,
                                               kh, kw))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_chs))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        conv_kernel_init_goog(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, b, l, r = explicit_padding(self.padding, self.kernel_size,
                                      self.dilation, self.stride,
                                      x.shape[-2], x.shape[-1])
        if t == b and l == r:
            return F.conv2d(x, self.weight, self.bias, self.stride, (t, l),
                            self.dilation, self.groups)
        x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def create_conv2d(in_chs: int, out_chs: int, kernel_size, **kwargs) -> Conv2d:
    """Plain or depthwise conv (``depthwise=True`` maps to ``groups=out_chs``).
    Mixed (list) kernels are not ported."""
    if isinstance(kernel_size, (list, tuple)):
        if len(kernel_size) > 1:
            raise NotImplementedError(
                "MixedConv2d (list kernel sizes) is not ported")
        kernel_size = kernel_size[0]
    if kwargs.pop("depthwise", False):
        kwargs["groups"] = out_chs
    return Conv2d(in_chs, out_chs, kernel_size, **kwargs)
