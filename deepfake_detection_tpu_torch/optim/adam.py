"""Adam and its kin with optax's semantics.

Counterpart of the JAX factory's ``adam``, ``adamw``, ``nadam`` and
``radam`` (``optax.adam``, ``optax.adamw``, ``optax.nadam``,
``optax.radam``):

* moments ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``, both
  bias-corrected by ``1 - b^t`` and eps outside the square root;
* ``nesterov`` (nadam): ``mû = b1·mu/(1 - b1^(t+1)) + (1 - b1)·g/(1 -
  b1^t)``, which is not ``torch.optim.NAdam``'s momentum-decay schedule;
* ``rectify`` (radam): optax's rectification, ``r·mû/(√nû + eps)`` once
  ``ρ_t ≥ 5`` and the bare ``mû`` before, which is not
  ``torch.optim.RAdam``'s;
* ``decoupled`` (adamw): ``wd·p`` added to the Adam direction before the
  lr scale, so the step is ``-lr·(adam + wd·p)`` (the factory divides wd
  by lr first, as the JAX factory does); otherwise weight decay is coupled
  (added to the gradient).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .base import ForeachOptimizer, coupled_decay

__all__ = ["Adam", "adam_direction"]


def adam_direction(group: Dict, grads: List[torch.Tensor],
                   states: List[Dict], count: torch.Tensor,
                   nesterov: bool = False) -> List[torch.Tensor]:
    """optax's ``scale_by_adam``: update the moments in ``states`` and
    return ``mû / (√nû + eps)`` (with ``nesterov``, Nadam's ``mû``); with
    ``group['rectify']``, ``scale_by_radam``'s direction instead."""
    b1, b2 = group["betas"]
    mu = [s["exp_avg"] for s in states]
    nu = [s["exp_avg_sq"] for s in states]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1.0 - b2))
    bc1 = 1.0 - torch.pow(b1, count)
    if nesterov:
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(b1, count + 1.0))
        torch._foreach_mul_(mu_hat, b1)
        torch._foreach_add_(mu_hat, torch._foreach_mul(
            torch._foreach_div(grads, bc1), 1.0 - b1))
    else:
        mu_hat = torch._foreach_div(mu, bc1)
    denom = torch._foreach_div(nu, 1.0 - torch.pow(b2, count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, group["eps"])
    if not group.get("rectify"):
        return torch._foreach_div(mu_hat, denom)
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = torch.pow(b2, count)
    ro = ro_inf - 2 * count * b2t / (1 - b2t)
    r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                   / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
    rectified = ro >= group["threshold"]
    # r·mû/(√nû + eps) once rectified, else mû: each term exact where it
    # is chosen (r is NaN while ρ < 4, so it is zeroed, not multiplied)
    direction = torch._foreach_mul(mu_hat, torch.where(
        rectified, r, torch.zeros_like(r)))
    direction = torch._foreach_div(direction, denom)
    torch._foreach_mul_(mu_hat, (~rectified).to(r.dtype))
    torch._foreach_add_(direction, mu_hat)
    return direction


class Adam(ForeachOptimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decoupled: bool = False, nesterov: bool = False,
                 rectify: bool = False, threshold: float = 5.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"lr={lr} eps={eps} weight_decay="
                             f"{weight_decay} must be >= 0")
        if nesterov and rectify:
            raise ValueError("the JAX factory's radam is not nesterov")
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            decoupled=decoupled, nesterov=nesterov, rectify=rectify,
            threshold=threshold))

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p)
        st["exp_avg_sq"] = torch.zeros_like(p)

    def _deltas(self, group, params, grads, states, count):
        wd = group["weight_decay"]
        if not group["decoupled"]:
            grads = coupled_decay(grads, params, wd)
        u = adam_direction(group, grads, states, count, group["nesterov"])
        if group["decoupled"] and wd:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        return self._scale_lr(u, group["lr"])
