"""Batch normalization with flax's statistics and timm's names.

Counterpart of ``BatchNorm2d`` / ``resolve_bn_args`` in
``deepfake_detection_tpu/ops/norm.py``.  The module carries timm's state
(``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``) but computes what the JAX package computes:

* eval: ``(x - running_mean) * (rsqrt(running_var + eps) * weight) + bias``;
* train: f32 batch statistics ``E[x]`` and ``max(0, E[x²] - E[x]²)`` — the
  **biased** variance — and a running update in flax convention
  (``m = 1 - momentum``; ``running = m * running + (1 - m) * batch``).
  torch's own ``F.batch_norm`` would store the unbiased variance instead,
  so it is not used here.

``momentum`` is torch convention (default 0.1), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

__all__ = ["BN_MOMENTUM_TF_DEFAULT", "BN_EPS_TF_DEFAULT",
           "BN_MOMENTUM_PT_DEFAULT", "BN_EPS_PT_DEFAULT", "resolve_bn_args",
           "BatchNorm2d"]

BN_MOMENTUM_TF_DEFAULT = 0.01
BN_EPS_TF_DEFAULT = 1e-3
BN_MOMENTUM_PT_DEFAULT = 0.1
BN_EPS_PT_DEFAULT = 1e-5


def resolve_bn_args(kwargs: dict) -> dict:
    """Fold bn_tf/bn_momentum/bn_eps kwargs into explicit momentum/eps;
    momentum stays torch-convention here."""
    bn_args = {}
    if kwargs.pop("bn_tf", False):
        bn_args = dict(momentum=BN_MOMENTUM_TF_DEFAULT, eps=BN_EPS_TF_DEFAULT)
    bn_momentum = kwargs.pop("bn_momentum", None)
    if bn_momentum is not None:
        bn_args["momentum"] = bn_momentum
    bn_eps = kwargs.pop("bn_eps", None)
    if bn_eps is not None:
        bn_args["eps"] = bn_eps
    return bn_args


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class BatchNorm2d(nn.Module):
    """NCHW batch norm; see the module docstring for its arithmetic."""

    def __init__(self, num_features: int,
                 momentum: float = BN_MOMENTUM_PT_DEFAULT,
                 eps: float = BN_EPS_PT_DEFAULT):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval affine ``(scale, shift)`` with the running stats folded in,
        ``y = x * scale + shift`` — the fused depthwise epilogue."""
        scale = self.weight.float() * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias.float() - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - _channel(self.running_mean)) * _channel(mul)
                    + _channel(self.bias)).to(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        with torch.no_grad():
            m = 1.0 - self.momentum
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - _channel(mean)) * _channel(mul)
                + _channel(self.bias)).to(x.dtype)
