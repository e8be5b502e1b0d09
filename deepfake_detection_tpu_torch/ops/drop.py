"""Stochastic depth, DropBlock and dropout.

Counterpart of ``drop_path`` / ``DropPath`` and ``drop_block_2d`` /
``DropBlock2d`` in ``deepfake_detection_tpu/ops/drop.py`` and of the
head's ``nn.Dropout``.  The JAX versions take an explicit PRNG key; here
the caller passes an explicit ``torch.Generator``.  All are identity in
eval.

DropBlock (:func:`drop_block_2d`) computes what the JAX function computes
from its Bernoulli seeds (:func:`drop_block_from_seeds` takes them as an
argument, so a test can feed it the JAX draw): seeds kept only at valid
centres, dilated by a ``clipped``² max-pool with flax's SAME pads
(``(k - 1) // 2`` before, ``k // 2`` after: not symmetric at an even
``clipped``), and the kept map rescaled by ``size / max(kept, 1)`` over
the whole batch.  The JAX package sums the kept map in f32 (jnp's sum of a
bf16 array accumulates in f32) and rounds the count, the size and their
quotient to ``x``'s dtype; so does this one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["drop_path", "DropPath", "dropout", "drop_block_gamma",
           "drop_block_from_seeds", "drop_block_2d", "DropBlock2d"]


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


def drop_block_gamma(h: int, w: int, drop_prob: float, block_size: int,
                     gamma_scale: float = 1.0):
    """``(clipped, gamma)``: the block side on an ``h×w`` map and the seed
    probability that drops ``drop_prob`` of it in expectation."""
    clipped = min(block_size, min(h, w))
    gamma = (gamma_scale * drop_prob * (h * w) / (clipped ** 2) /
             ((h - clipped + 1) * (w - clipped + 1)))
    return clipped, gamma


def drop_block_from_seeds(x: torch.Tensor, seeds: torch.Tensor,
                          block_size: int = 7,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """DropBlock of an NCHW ``x`` from its seed mask (``x``'s shape; any
    nonzero is a seed); with ``noise``, dropped pixels take it instead of
    the rescale."""
    h, w = x.shape[-2:]
    clipped = min(block_size, min(h, w))
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    valid = (((rows >= clipped // 2) & (rows < h - (clipped - 1) // 2))
             [:, None] & ((cols >= clipped // 2)
                          & (cols < w - (clipped - 1) // 2))[None, :])
    seeds = (seeds.to(x.device) != 0) & valid
    lo, hi = (clipped - 1) // 2, clipped // 2
    block = F.max_pool2d(F.pad(seeds.to(torch.float32), (lo, hi, lo, hi)),
                         clipped, 1)
    keep = 1.0 - block
    if noise is not None:
        return x * keep.to(x.dtype) + noise.to(x.dtype) * block.to(x.dtype)
    kept = (block == 0).sum().to(torch.float32).to(x.dtype).clamp_min(1.0)
    size = torch.tensor(float(keep.numel()), device=x.device).to(x.dtype)
    normalize = (size.float() / kept.float()).to(x.dtype)
    return x * (keep.to(x.dtype) * normalize)


def drop_block_2d(x: torch.Tensor, drop_prob: float = 0.1,
                  block_size: int = 7, gamma_scale: float = 1.0,
                  with_noise: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """DropBlock on an NCHW ``x``: Bernoulli(gamma) seeds drawn on
    ``generator``'s device (then, with ``with_noise``, N(0, 1) noise from
    it too), see :func:`drop_block_from_seeds`."""
    if drop_prob <= 0.0:
        return x
    if generator is None:
        raise ValueError("stochastic regularizers need an explicit "
                         "torch.Generator")
    _, gamma = drop_block_gamma(x.shape[-2], x.shape[-1], drop_prob,
                                block_size, gamma_scale)
    seeds = torch.rand(x.shape, generator=generator,
                       device=generator.device) < gamma
    noise = None
    if with_noise:
        noise = torch.randn(x.shape, generator=generator,
                            device=generator.device).to(x.device)
    return drop_block_from_seeds(x, seeds, block_size, noise)


class DropBlock2d(nn.Module):
    """Module wrapper; the generator rides the forward call."""

    def __init__(self, drop_prob: float = 0.1, block_size: int = 7,
                 gamma_scale: float = 1.0, with_noise: bool = False):
        super().__init__()
        self.drop_prob = drop_prob
        self.block_size = block_size
        self.gamma_scale = gamma_scale
        self.with_noise = with_noise

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.drop_prob <= 0.0:
            return x
        return drop_block_2d(x, self.drop_prob, self.block_size,
                             self.gamma_scale, self.with_noise, generator)
