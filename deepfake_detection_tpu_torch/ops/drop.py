"""Stochastic depth and dropout.

Counterpart of ``drop_path`` / ``DropPath`` in
``deepfake_detection_tpu/ops/drop.py`` and of the head's ``nn.Dropout``.
The JAX versions take an explicit PRNG key; here the caller passes an
explicit ``torch.Generator``.  Both are identity in eval.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

__all__ = ["drop_path", "DropPath", "dropout"]


def _keep_mask(shape, keep_prob: float, generator: Optional[torch.Generator],
               like: torch.Tensor) -> torch.Tensor:
    if generator is None:
        raise ValueError("stochastic regularizers need an explicit "
                         "torch.Generator")
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < keep_prob).to(device=like.device, dtype=like.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout: survivors scaled by 1/keep."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    return x / keep_prob * _keep_mask(x.shape, keep_prob, generator, x)


def drop_path(x: torch.Tensor, drop_prob: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample stochastic depth: zero the whole residual branch for a
    random subset of samples, rescale survivors by 1/keep.  The mask is
    drawn on ``generator``'s device and moved to ``x``'s."""
    if drop_prob <= 0.0:
        return x
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return x / keep_prob * _keep_mask(shape, keep_prob, generator, x)


class DropPath(nn.Module):
    """Module wrapper; the generator rides the forward call."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.drop_prob <= 0.0:
            return x
        return drop_path(x, self.drop_prob, generator)
