"""LAMB with optax's semantics.

Counterpart of the JAX factory's ``lamb`` (``optax.lamb``): Adam's
direction (``scale_by_adam``), plus ``wd·p`` on the decayed group, scaled
per tensor by the trust ratio ``‖p‖ / ‖u‖`` (1 where either norm is 0),
then by ``-lr``.  ``torch``'s timm-style LAMB clips the ratio and
bias-corrects differently; this is optax's.
"""

from __future__ import annotations

import torch

from .adam import adam_direction
from .base import ForeachOptimizer

__all__ = ["Lamb"]


class Lamb(ForeachOptimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"lr={lr} eps={eps} weight_decay="
                             f"{weight_decay} must be >= 0")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p)
        st["exp_avg_sq"] = torch.zeros_like(p)

    def _deltas(self, group, params, grads, states, count):
        u = adam_direction(group, grads, states, count)
        if group["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(
                params, group["weight_decay"]))
        p_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        torch._foreach_mul_(u, ratio.unbind())
        return self._scale_lr(u, group["lr"])
