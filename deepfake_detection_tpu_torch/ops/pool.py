"""Global pooling head.

Counterpart of ``adaptive_pool_feat_mult``, ``global_pool_nhwc`` and
``SelectAdaptivePool2d`` in ``deepfake_detection_tpu/ops/pool.py``; the
port pools NCHW-shaped tensors over dims (2, 3).
"""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["adaptive_pool_feat_mult", "global_pool_nchw",
           "SelectAdaptivePool2d"]


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
