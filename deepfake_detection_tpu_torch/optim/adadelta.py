"""Adadelta with optax's semantics.

Counterpart of the JAX factory's ``adadelta`` (``optax.adadelta`` after
the coupled decay): ``E[g²] = (1 - ρ)·g² + ρ·E[g²]``, the step
``√(E[Δx²] + eps) / √(E[g²] + eps) · g``, then ``E[Δx²] = (1 - ρ)·Δx² +
ρ·E[Δx²]`` of that step before the lr scale, and ``-lr`` times it.  It
equals ``torch.optim.Adadelta`` but for where eps and the lr enter; the
port keeps optax's arithmetic order.
"""

from __future__ import annotations

import torch

from .base import ForeachOptimizer, coupled_decay

__all__ = ["Adadelta"]


class Adadelta(ForeachOptimizer):
    def __init__(self, params, lr: float = 1.0, rho: float = 0.9,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"lr={lr} eps={eps} weight_decay="
                             f"{weight_decay} must be >= 0")
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, st):
        st["square_avg"] = torch.zeros_like(p)
        st["acc_delta"] = torch.zeros_like(p)

    def _deltas(self, group, params, grads, states, count):
        rho, eps = group["rho"], group["eps"]
        grads = coupled_decay(grads, params, group["weight_decay"])
        e_g = [s["square_avg"] for s in states]
        e_x = [s["acc_delta"] for s in states]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_add_(e_g, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - rho))
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        u = torch._foreach_mul(torch._foreach_div(num, den), grads)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_add_(e_x, torch._foreach_mul(
            torch._foreach_mul(u, u), 1.0 - rho))
        return self._scale_lr(u, group["lr"])
