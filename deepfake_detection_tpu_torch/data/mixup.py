"""Mixup.

Counterpart of ``deepfake_detection_tpu/data/mixup.py``: the collate-time
:class:`FastCollateMixup` (numpy on the host, a copy of the JAX package's)
mixes the uint8 batch with its reversed self under one Beta-drawn ``lam``
and emits label-smoothed soft targets (with ``blend=False``, as the loader
sets under the device augment chain, it draws ``lam`` and computes the
targets only, and the device prologue blends with the same ``lam``);
:func:`mixup_batch` is the in-loop
version on tensors, drawing ``lam`` from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["one_hot_np", "mixup_target_np", "FastCollateMixup",
           "mixup_batch"]


def one_hot_np(x: np.ndarray, num_classes: int, on_value: float = 1.0,
               off_value: float = 0.0) -> np.ndarray:
    out = np.full((len(x), num_classes), off_value, dtype=np.float32)
    out[np.arange(len(x)), x] = on_value
    return out


def mixup_target_np(target: np.ndarray, num_classes: int, lam: float = 1.0,
                    smoothing: float = 0.0) -> np.ndarray:
    """Soft targets ``lam · y + (1-lam) · y[::-1]``, label-smoothed."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = one_hot_np(target, num_classes, on, off)
    y2 = one_hot_np(target[::-1], num_classes, on, off)
    return lam * y1 + (1.0 - lam) * y2


class FastCollateMixup:
    """Collate-time uint8 mixup with an explicit numpy generator.

    Call with the stacked uint8 batch ``(B, H, W, C)`` and int labels;
    returns the mixed uint8 batch (unmixed when ``blend`` is off) and
    float32 soft targets."""

    def __init__(self, mixup_alpha: float = 1.0, label_smoothing: float = 0.1,
                 num_classes: int = 1000, blend: bool = True):
        self.mixup_alpha = mixup_alpha
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.mixup_enabled = True
        self.blend = blend

    def __call__(self, images: np.ndarray, targets: np.ndarray,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        lam = 1.0
        if self.mixup_enabled:
            lam = float(rng.beta(self.mixup_alpha, self.mixup_alpha))
        soft = mixup_target_np(targets, self.num_classes, lam,
                               self.label_smoothing)
        if lam == 1.0 or not self.blend:
            return images, soft
        mixed = images.astype(np.float32) * lam + \
            images[::-1].astype(np.float32) * (1.0 - lam)
        np.round(mixed, out=mixed)
        return mixed.astype(np.uint8), soft


def mixup_batch(images: torch.Tensor, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                alpha: float = 0.2, num_classes: int = 1000,
                smoothing: float = 0.1, disable: bool = False,
                lam: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-loop mixup of a float batch with its reversed self.  ``lam`` is
    drawn from Beta(alpha, alpha) on ``generator`` unless given (tests pass
    the JAX draw); ``disable`` fixes it at 1."""
    if disable:
        lam = 1.0
    elif lam is None:
        if generator is None:
            raise ValueError("mixup_batch needs an explicit torch.Generator "
                             "or a lam")
        # Beta(a, a) = Ga / (Ga + Gb) with Ga, Gb ~ Gamma(a)
        conc = torch.full((2,), float(alpha), dtype=torch.float64,
                          device=generator.device)
        g = torch._standard_gamma(conc, generator=generator)
        lam = float(g[0] / g.sum())
    mixed = images * lam + torch.flip(images, dims=(0,)) * (1.0 - lam)
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    oh = torch.nn.functional.one_hot(targets.long(), num_classes).float()
    y1 = oh * (on - off) + off
    y2 = torch.flip(oh, dims=(0,)) * (on - off) + off
    return mixed, lam * y1 + (1.0 - lam) * y2
