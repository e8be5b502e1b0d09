"""Metrics.

Counterpart of ``AverageMeter``, ``LatencyHistogram``, ``accuracy`` and
``masked_mean`` in ``deepfake_detection_tpu/utils/metrics.py``;
``LatencyHistogram`` lives in :mod:`.prometheus`, as there.  ``accuracy`` and
``masked_mean`` return device tensors, so the train step reads nothing back
to the host; the trainer drains them at its log interval.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .prometheus import LatencyHistogram

__all__ = ["AverageMeter", "LatencyHistogram", "accuracy", "masked_mean"]


class AverageMeter:
    """Running average of host floats."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: float = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def accuracy(output: torch.Tensor, target: torch.Tensor,
             topk: Sequence[int] = (1,),
             weight: Optional[torch.Tensor] = None
             ) -> Union[torch.Tensor, list]:
    """Top-k precision in percent.  Soft targets (the shape of ``output``)
    collapse to their argmax; ties rank the lower class first, as the JAX
    package's stable argsort does.  ``weight`` masks padded samples."""
    maxk = max(topk)
    if target.shape == output.shape:
        target = torch.argmax(target, dim=-1)
    pred = torch.argsort(-output, dim=-1, stable=True)[:, :maxk]
    correct = (pred == target[:, None]).float()
    if weight is None:
        denom = float(target.shape[0])
        w = 1.0
    else:
        w = weight[:, None].float()
        denom = torch.clamp(weight.float().sum(), min=1.0)
    accs = [(correct[:, :k] * w).sum() * 100.0 / denom for k in topk]
    return accs[0] if len(topk) == 1 else accs


def masked_mean(x: torch.Tensor, weight: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Mean over the entries whose ``weight`` is non-zero (all if None)."""
    if weight is None:
        return x.mean()
    w = weight.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)
