"""Exponential moving average of a model's whole state.

Counterpart of ``deepfake_detection_tpu/utils/ema.py``: the EMA tracks every
floating entry of the state dict, parameters **and** BN running statistics,
as ``ema = decay · ema + (1 - decay) · value`` (decay 0.9998 by default), and
copies integer buffers (``num_batches_tracked``).  It holds its own copy of
the model, in eval mode, on the model's device.
"""

from __future__ import annotations

import copy
from typing import List

import torch
import torch.nn as nn

__all__ = ["ModelEma"]


class ModelEma:
    """EMA copy of ``model``; call :meth:`update` after each optimizer
    step."""

    def __init__(self, model: nn.Module, decay: float = 0.9998):
        self.decay = decay
        self.module = copy.deepcopy(model).eval()
        for p in self.module.parameters():
            p.requires_grad_(False)

    def _pairs(self, model: nn.Module):
        own = self.module.state_dict()
        new = model.state_dict()
        floats: List = [[], []]
        ints: List = [[], []]
        for k, e in own.items():
            target = floats if e.is_floating_point() else ints
            target[0].append(e)
            target[1].append(new[k].detach())
        return floats, ints

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        (ema, cur), (ema_i, cur_i) = self._pairs(model)
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, torch._foreach_mul(cur, 1.0 - self.decay))
        for e, v in zip(ema_i, cur_i):
            e.copy_(v)

    def state_dict(self):
        return self.module.state_dict()
