"""Metrics.

Counterpart of ``AverageMeter``, ``LatencyHistogram``, ``accuracy``,
``auc`` and ``masked_mean`` in ``deepfake_detection_tpu/utils/metrics.py``;
``LatencyHistogram`` lives in :mod:`.prometheus`, as there.  ``accuracy`` and
``masked_mean`` return device tensors, so the train step reads nothing back
to the host; the trainer drains them at its log interval.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from .prometheus import LatencyHistogram

__all__ = ["AverageMeter", "LatencyHistogram", "accuracy", "auc",
           "masked_mean"]


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


def auc(scores: torch.Tensor, labels: torch.Tensor,
        weight: Optional[torch.Tensor] = None) -> float:
    """ROC AUC by the rank statistic (Mann–Whitney U), ties at their
    midrank, as the JAX ``auc``: ``scores`` higher for the positive class,
    ``labels`` in {0, 1}, ``weight`` a validity mask (rows with weight 0
    are left out).  Computed in float64 on the host."""
    scores = scores.detach().reshape(-1).to("cpu", torch.float64)
    labels = labels.detach().reshape(-1).to("cpu")
    valid = torch.ones_like(scores) if weight is None else \
        (weight.detach().reshape(-1).to("cpu") > 0).to(torch.float64)
    s = torch.where(valid > 0, scores, torch.full_like(scores, math.inf))
    order = torch.argsort(s, stable=True)
    sorted_s = s[order].contiguous()
    first = torch.searchsorted(sorted_s, sorted_s, side="left")
    last = torch.searchsorted(sorted_s, sorted_s, side="right")
    ranks = torch.empty_like(scores)
    ranks[order] = (first + last + 1).to(torch.float64) / 2.0
    pos = (labels > 0).to(torch.float64) * valid
    neg = (labels == 0).to(torch.float64) * valid
    n_pos, n_neg = float(pos.sum()), float(neg.sum())
    u = float((ranks * pos).sum()) - n_pos * (n_pos + 1) / 2.0
    return u / max(n_pos * n_neg, 1.0)


def masked_mean(x: torch.Tensor, weight: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Mean over the entries whose ``weight`` is non-zero (all if None)."""
    if weight is None:
        return x.mean()
    w = weight.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)
