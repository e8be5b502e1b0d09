"""Global pooling head and the torch-windowed pools.

Counterpart of ``adaptive_pool_feat_mult``, ``global_pool_nhwc``,
``SelectAdaptivePool2d``, ``max_pool2d_torch``, ``avg_pool2d_torch`` and
``avg_pool2d_same`` in ``deepfake_detection_tpu/ops/pool.py``; the port
pools NCHW-shaped tensors over dims (2, 3).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["adaptive_pool_feat_mult", "global_pool_nchw",
           "SelectAdaptivePool2d", "max_pool2d_torch", "avg_pool2d_torch",
           "avg_pool2d_same"]


def adaptive_pool_feat_mult(pool_type: str = "avg") -> int:
    """Output-channel multiplier: 2 for catavgmax else 1."""
    return 2 if pool_type == "catavgmax" else 1


def global_pool_nchw(x: torch.Tensor, pool_type: str = "avg") -> torch.Tensor:
    """Global spatial pool NCHW → NC."""
    if not pool_type:
        return x
    avg = x.mean(dim=(2, 3))
    if pool_type == "avg":
        return avg
    mx = x.amax(dim=(2, 3))
    if pool_type == "max":
        return mx
    if pool_type == "avgmax":
        return 0.5 * (avg + mx)
    if pool_type == "catavgmax":
        return torch.cat([avg, mx], dim=1)
    raise ValueError(f"Invalid pool type: {pool_type!r}")


class SelectAdaptivePool2d(nn.Module):
    """Selectable global pooling head."""

    def __init__(self, pool_type: str = "avg", flatten: bool = True):
        super().__init__()
        self.pool_type = pool_type
        self.flatten = flatten

    def feat_mult(self) -> int:
        return adaptive_pool_feat_mult(self.pool_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = global_pool_nchw(x, self.pool_type)
        if not self.flatten and out.ndim == 2:
            out = out[:, :, None, None]
        return out


def max_pool2d_torch(x: torch.Tensor, kernel_size: int, stride: int,
                     padding: int = 0, ceil_mode: bool = False
                     ) -> torch.Tensor:
    """``nn.MaxPool2d``'s windows, as the JAX package's ``max_pool2d_torch``
    builds them: symmetric padding (never a maximum), and under
    ``ceil_mode`` a last partial window kept unless it would start in the
    right padding."""
    return F.max_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode)


def avg_pool2d_torch(x: torch.Tensor, kernel_size: int, stride: int,
                     padding: int = 0, count_include_pad: bool = True
                     ) -> torch.Tensor:
    """``nn.AvgPool2d`` in floor mode: symmetric zero padding, counted in
    the divisor when ``count_include_pad`` (the res2net downsample's
    ``AvgPool2d(3, stride, padding=1)``)."""
    return F.avg_pool2d(x, kernel_size, stride, padding,
                        count_include_pad=count_include_pad)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    need = max((-(-n // s) - 1) * s + k - n, 0)
    return need // 2, need - need // 2


def avg_pool2d_same(x: torch.Tensor, kernel_size: int, stride: int,
                    count_include_pad: bool = True) -> torch.Tensor:
    """TF SAME average pool: the pad of ``k - 1`` beyond the strides is
    split with the extra pixel after (at an odd map, ``k = s = 2`` pads
    (0, 1)); without ``count_include_pad`` each window's sum is divided by
    its pixels inside the map."""
    t, b = _same_pads(x.shape[-2], kernel_size, stride)
    l, r = _same_pads(x.shape[-1], kernel_size, stride)
    if t == b == l == r == 0:
        return F.avg_pool2d(x, kernel_size, stride)
    xp = F.pad(x, (l, r, t, b))
    if count_include_pad:
        return F.avg_pool2d(xp, kernel_size, stride)
    ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[-2:])), (l, r, t, b))
    summed = F.avg_pool2d(xp, kernel_size, stride, divisor_override=1)
    return summed / F.avg_pool2d(ones, kernel_size, stride,
                                 divisor_override=1)
