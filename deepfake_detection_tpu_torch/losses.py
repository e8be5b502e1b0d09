"""Classification losses.

Counterpart of ``deepfake_detection_tpu/losses.py``: plain, label-smoothing,
soft-target and AugMix-JSD cross entropy, and :func:`create_loss_fn` with the
reference runner's precedence jsd > mixup (soft targets) > label smoothing >
plain CE.  Each loss maps ``(logits, target)`` to a scalar tensor; the
optional ``weight`` is a validity mask over the batch (padded eval batches).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .utils.metrics import masked_mean

__all__ = ["cross_entropy", "label_smoothing_cross_entropy",
           "soft_target_cross_entropy", "jsd_cross_entropy", "create_loss_fn"]


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain CE with integer labels."""
    return masked_mean(_nll(torch.log_softmax(logits, dim=-1), labels),
                       weight)


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1,
                                  weight: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """``(1-s) · nll + s · mean(-logp)``."""
    if not smoothing < 1.0:
        raise ValueError(f"smoothing must be < 1, got {smoothing}")
    logp = torch.log_softmax(logits, dim=-1)
    smooth = -logp.mean(dim=-1)
    return masked_mean((1.0 - smoothing) * _nll(logp, labels)
                       + smoothing * smooth, weight)


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                              weight: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """CE against soft targets (the mixup collate's)."""
    logp = torch.log_softmax(logits, dim=-1)
    return masked_mean((-target * logp).sum(dim=-1), weight)


def jsd_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                      num_splits: int = 3, alpha: float = 12.0,
                      smoothing: float = 0.1) -> torch.Tensor:
    """AugMix JSD loss: CE on the clean (first) split plus ``alpha`` times
    the mean KL of every split's softmax to the mixture."""
    split = logits.shape[0] // num_splits
    if split * num_splits != logits.shape[0]:
        raise ValueError(f"batch {logits.shape[0]} is not {num_splits} "
                         f"equal splits")
    clean = logits[:split]
    if smoothing and smoothing > 0:
        loss = label_smoothing_cross_entropy(clean, labels[:split], smoothing)
    else:
        loss = cross_entropy(clean, labels[:split])
    probs = torch.softmax(logits.reshape(num_splits, split, -1), dim=-1)
    logp_mix = torch.log(torch.clamp(probs.mean(dim=0), 1e-7, 1.0))
    kl = probs * (torch.log(torch.clamp(probs, 1e-7, 1.0)) - logp_mix[None])
    kl = kl.sum(dim=(1, 2)) / split
    return loss + alpha * kl.mean()


def create_loss_fn(cfg) -> Callable:
    """The train loss for a config with ``jsd``, ``aug_splits``, ``mixup``
    and ``smoothing`` attributes (missing ones read as off)."""
    if getattr(cfg, "jsd", False):
        ns = getattr(cfg, "aug_splits", 0)
        if ns <= 1:
            raise ValueError("--jsd requires --aug-splits > 1")
        return lambda logits, target, weight=None: jsd_cross_entropy(
            logits, target, num_splits=ns, smoothing=cfg.smoothing)
    if getattr(cfg, "mixup", 0.0) > 0:
        return soft_target_cross_entropy
    if getattr(cfg, "smoothing", 0.0) > 0:
        return lambda logits, target, weight=None: \
            label_smoothing_cross_entropy(logits, target, cfg.smoothing,
                                          weight)
    return cross_entropy
