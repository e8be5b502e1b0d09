"""Convolutions: padding resolution, plain and depthwise ``Conv2d``.

Counterpart of ``deepfake_detection_tpu/ops/conv.py`` (``resolve_padding``,
``Conv2d``, ``MixedConv2d``, ``CondConv2d``, ``create_conv2d``, the goog
initializers).  Tensors are NCHW-shaped, held in ``torch.channels_last``
memory; weights are OIHW with timm's parameter names (``weight``, ``bias``).

``MixedConv2d`` (MixNet) keeps timm's layout, a module dict of arms
``<name>.{i}``; ``CondConv2d`` keeps timm's flat experts, ``weight`` of
shape ``(E, out·in/g·kh·kw)``.  Both are ordinary torch convolutions, as
the JAX package computes them with XLA outside its Pallas kernels, and both
hand on their output in channels_last memory, the layout the depthwise
kernel reads.

Padding carries checkpoint-parity semantics: pad_type ``''`` is the
reference's STATIC symmetric torch padding, ``'same'`` is TF SAME (padding
depends on the input size and may be asymmetric), ``'valid'`` none, an int
explicit symmetric padding.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["resolve_padding", "explicit_padding", "conv_kernel_init_goog",
           "dense_init_goog", "cast_compute", "Conv2d", "MixedConv2d",
           "CondConv2d", "create_conv2d"]


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


def cast_compute(dtype: Optional[torch.dtype], *tensors):
    """``tensors`` cast to ``dtype`` (None passes through as is); a
    cast's gradient comes back in the source dtype."""
    return tuple(t if t is None or dtype is None else t.to(dtype)
                 for t in tensors)


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

    compute_dtype: Optional[torch.dtype] = None

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
        x, w, bias = cast_compute(self.compute_dtype, x, self.weight,
                                  self.bias)
        return _conv(x, w, bias, self.padding, self.kernel_size, self.stride,
                     self.dilation, self.groups)


def _conv(x, w, bias, padding, kernel_size, stride, dilation, groups):
    """``F.conv2d`` with the reference's padding for ``x``'s size: one conv
    for symmetric padding, a pad then a conv for asymmetric TF SAME."""
    t, b, l, r = explicit_padding(padding, kernel_size, dilation, stride,
                                  x.shape[-2], x.shape[-1])
    if t == b and l == r:
        return F.conv2d(x, w, bias, stride, (t, l), dilation, groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), w, bias, stride, 0, dilation,
                    groups)


def _split_sizes(n: int, parts: int) -> List[int]:
    """``np.array_split``'s sizes: the first ``n % parts`` take one more."""
    q, rem = divmod(n, parts)
    return [q + 1] * rem + [q] * (parts - rem)


class MixedConv2d(nn.ModuleDict):
    """Channel-split multi-kernel conv (MixNet): input and output channels
    split as ``np.array_split`` does (the first arms take the remainder),
    arm ``i`` convolves its split with ``kernel_size[i]``.  A depthwise arm
    needs as many output as input channels, as in the JAX package."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: Sequence[int],
                 stride=1, dilation=1, depthwise: bool = False,
                 padding: Union[str, int, None] = "", bias: bool = False):
        super().__init__()
        n = len(kernel_size)
        self.in_splits = _split_sizes(in_chs, n)
        out_splits = _split_sizes(out_chs, n)
        for i, (k, ic, oc) in enumerate(zip(kernel_size, self.in_splits,
                                            out_splits)):
            if depthwise and ic != oc:
                raise ValueError(
                    f"MixedConv2d depthwise split {i}: input split has {ic} "
                    f"channels but the output split has {oc} — depthwise "
                    f"requires in == out per split (in_chs={in_chs}, "
                    f"out_chs={out_chs}, kernels={tuple(kernel_size)})")
            self[str(i)] = Conv2d(ic, oc, k, stride, dilation,
                                  groups=ic if depthwise else 1,
                                  padding=padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = torch.split(x, self.in_splits, dim=1)
        y = torch.cat([conv(xi) for conv, xi in zip(self.values(), xs)], 1)
        return y.contiguous(memory_format=torch.channels_last)


class CondConv2d(nn.Module):
    """Conditionally parameterized conv: ``num_experts`` kernels mixed per
    sample by routing weights ``(B, E)``, then each sample convolved with
    its own kernel, as one grouped conv over ``(1, B·C, H, W)``.  ``weight``
    holds the experts flat, ``(E, out·in/g·kh·kw)`` (timm's layout).  As
    the JAX package (whose ``weight`` is f32 and whose mixed kernel takes
    its dtype), the mix and the conv run in f32; the output is in the
    compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_chs: int, out_chs: int, kernel_size=3, stride=1,
                 dilation=1, groups: int = 1, num_experts: int = 4,
                 padding: Union[str, int, None] = "", bias: bool = False):
        super().__init__()
        kh, kw = _to_tuple(kernel_size)
        self.kernel_size = (kh, kw)
        self.stride = _to_tuple(stride)
        self.dilation = _to_tuple(dilation)
        self.groups = groups
        self.padding = padding
        self.num_experts = num_experts
        self.weight_shape = (out_chs, in_chs // groups, kh, kw)
        self.weight = nn.Parameter(torch.empty(
            num_experts, math.prod(self.weight_shape)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(num_experts, out_chs))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each expert's goog init on its ``(out, in/g, kh, kw)`` kernel."""
        with torch.no_grad():
            for e in range(self.num_experts):
                conv_kernel_init_goog(self.weight[e].view(self.weight_shape),
                                      generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor,
                routing_weights: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        routing = routing_weights.to(self.weight.dtype)
        kernel = (routing @ self.weight).view(b * self.weight_shape[0],
                                              *self.weight_shape[1:])
        x = x.to(self.weight.dtype).reshape(1, b * c, h, w)
        y = _conv(x, kernel, None, self.padding, self.kernel_size,
                  self.stride, self.dilation, b * self.groups)
        y = y.view(b, self.weight_shape[0], *y.shape[-2:])
        if self.bias is not None:
            y = y + (routing @ self.bias)[:, :, None, None]
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        return y.contiguous(memory_format=torch.channels_last)


def create_conv2d(in_chs: int, out_chs: int, kernel_size,
                  **kwargs) -> nn.Module:
    """The reference factory's dispatch: a list of kernel sizes builds a
    :class:`MixedConv2d`, one size a :class:`Conv2d` (``depthwise=True``
    maps to ``groups=out_chs``).  A :class:`CondConv2d` takes routing
    weights and is built by its block directly."""
    if isinstance(kernel_size, (list, tuple)) and len(kernel_size) > 1:
        depthwise = kwargs.pop("depthwise", False)
        kwargs.pop("groups", None)
        return MixedConv2d(in_chs, out_chs, kernel_size, depthwise=depthwise,
                           **kwargs)
    if isinstance(kernel_size, (list, tuple)):
        kernel_size = kernel_size[0]
    if kwargs.pop("depthwise", False):
        kwargs["groups"] = out_chs
    return Conv2d(in_chs, out_chs, kernel_size, **kwargs)
