"""Batch normalization with flax's statistics and timm's names.

Counterpart of ``BatchNorm2d``, ``SplitBatchNorm2d`` and
``resolve_bn_args`` in ``deepfake_detection_tpu/ops/norm.py``.  The module carries timm's state
(``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``) but computes what the JAX package computes:

* eval: ``(x - running_mean) * (rsqrt(running_var + eps) * weight) + bias``;
* train: f32 batch statistics ``E[x]`` and ``max(0, E[x²] - E[x]²)`` — the
  **biased** variance — and a running update in flax convention
  (``m = 1 - momentum``; ``running = m * running + (1 - m) * batch``).
  torch's own ``F.batch_norm`` would store the unbiased variance instead,
  so it is not used here.

``momentum`` is torch convention (default 0.1), as in the JAX package.

:class:`SplitBatchNorm2d` (AdvProp's auxiliary BN, ``--split-bn``) is a
:class:`BatchNorm2d` (the main BN, its tensors under the module's own name)
with ``num_splits - 1`` more in ``aux_bn`` (``<name>.aux_bn.<i>.*``), timm's
layout: in training the batch's equal chunks go through the main BN and
then each aux BN in turn, each with the arithmetic above; in eval the main
BN alone.

Both norms follow flax's ``dtype=`` policy under a bf16 compute dtype:
statistics and normalization in f32, the output in the compute dtype.
:class:`BatchNorm2d` returns its input's dtype (the compute dtype on the
policy's path, where every input already is); :class:`LayerNorm` takes its
``compute_dtype`` as :mod:`ops.conv` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BN_MOMENTUM_TF_DEFAULT", "BN_EPS_TF_DEFAULT",
           "BN_MOMENTUM_PT_DEFAULT", "BN_EPS_PT_DEFAULT", "resolve_bn_args",
           "BatchNorm2d", "SplitBatchNorm2d", "LayerNorm"]

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


class SplitBatchNorm2d(BatchNorm2d):
    """AdvProp split BN: in training, chunk ``i`` of ``num_splits`` equal
    chunks of the batch goes through BN ``i`` (0 the main BN, this module's
    own tensors; ``i`` ≥ 1 ``aux_bn[i - 1]``); in eval, the main BN for
    every row.  :meth:`folded` is the main BN's."""

    def __init__(self, num_features: int,
                 momentum: float = BN_MOMENTUM_PT_DEFAULT,
                 eps: float = BN_EPS_PT_DEFAULT, num_splits: int = 2):
        super().__init__(num_features, momentum=momentum, eps=eps)
        if num_splits < 2:
            raise ValueError(f"num_splits must be >= 2, got {num_splits}")
        self.num_splits = num_splits
        self.aux_bn = nn.ModuleList(
            BatchNorm2d(num_features, momentum=momentum, eps=eps)
            for _ in range(num_splits - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        split = x.shape[0] // self.num_splits
        if split * self.num_splits != x.shape[0]:
            raise ValueError(f"batch {x.shape[0]} is not {self.num_splits} "
                             f"equal splits")
        parts = [super().forward(x[:split])]
        for i, bn in enumerate(self.aux_bn):
            parts.append(bn(x[(i + 1) * split:(i + 2) * split]))
        return torch.cat(parts, dim=0)


class LayerNorm(nn.LayerNorm):
    """torch's ``nn.LayerNorm`` (timm's names); with ``compute_dtype`` set,
    flax's ``nn.LayerNorm(dtype=)``: f32 statistics and normalization of
    the widened input, the output in the compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)
